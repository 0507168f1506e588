"""Carry weights and optimizer state from a paddle_tpu model into the port
(LLaMA and GPT-MoE).

``from_paddle_tpu_params`` takes plain numpy arrays keyed by the JAX
package's parameter names, e.g.
``{name: np.asarray(p._value) for name, p in jax_model.named_parameters()}``
(this module imports nothing of JAX or paddle_tpu). Names map one to one;
linear weights are transposed from paddle's ``[in, out]`` to PyTorch's
``[out, in]`` (the ``*_proj.weight`` and ``lm_head.weight`` tensors); the
embedding tables, LayerNorms, expert tensors and the MoE gate's
``gate_weight [d, E]`` keep the JAX layout.
``optimizer_state_from_paddle_tpu`` carries a JAX optimizer's
``state_dict()`` (numpy m, v, master and the step) the same way, so a
resumed port step matches the JAX one.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.device import DEFAULT_DEVICE
from paddle_tpu_torch.models.gpt_moe import GptMoeConfig, GptMoeForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_paddle_tpu_params", "optimizer_state_from_paddle_tpu"]


def _to_port_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if name.endswith("_proj.weight") or name == "lm_head.weight":
        return arr.T                        # paddle [in, out] -> [out, in]
    return arr


@torch.no_grad()
def from_paddle_tpu_params(named: dict, config: LlamaConfig | GptMoeConfig,
                           device=DEFAULT_DEVICE, dtype=None):
    """A port ``LlamaForCausalLM`` (or ``GptMoeForCausalLM`` for a
    ``GptMoeConfig``) on `device` loaded from `named` ({paddle_tpu
    parameter name: np.ndarray}). Raises on a missing, unexpected or
    misshapen name."""
    cls = (GptMoeForCausalLM if isinstance(config, GptMoeConfig)
           else LlamaForCausalLM)
    model = cls(config, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named))
    extra = sorted(set(named) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for name, p in params.items():
        arr = _to_port_layout(name, np.asarray(named[name]))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"fit {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, copy=True)))
    return model


def optimizer_state_from_paddle_tpu(state: dict, names, model,
                                    optimizer) -> None:
    """Load a paddle_tpu optimizer's ``state_dict()`` into the port's
    `optimizer` over `model`. ``names[i]`` is the parameter name of the JAX
    optimizer's i-th parameter (``[n for n, _ in
    jax_model.named_parameters()]`` when it was built from
    ``jax_model.parameters()``); each state array is put in the port's
    layout as the weights are (linear moments and masters transposed).
    Raises on a name the port model lacks or a misshapen entry."""
    port_name = {id(p): n for n, p in model.named_parameters()}
    jax_index = {n: i for i, n in enumerate(names)}
    out = {"step": int(state.get("step", 0))}
    for j, p in enumerate(optimizer._params):
        name = port_name.get(id(p))
        if name is None or name not in jax_index:
            raise KeyError(f"optimizer parameter {j} ({name}) has no "
                           f"paddle_tpu counterpart")
        saved = state.get(f"param_{jax_index[name]}")
        if saved is None:
            continue
        entry = {}
        for k, v in saved.items():
            arr = _to_port_layout(name, np.asarray(v))
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}.{k}: shape {tuple(arr.shape)} "
                                 f"does not fit {tuple(p.shape)}")
            entry[k] = arr
        out[f"param_{j}"] = entry
    optimizer.set_state_dict(out)
