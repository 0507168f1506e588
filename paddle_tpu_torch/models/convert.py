"""Carry weights from a paddle_tpu model into the port.

``from_paddle_tpu_params`` takes plain numpy arrays keyed by the JAX
package's parameter names, e.g.
``{name: np.asarray(p._value) for name, p in jax_model.named_parameters()}``
(this module imports nothing of JAX or paddle_tpu). Names map one to one;
linear weights are transposed from paddle's ``[in, out]`` to PyTorch's
``[out, in]``; the embedding table is ``[vocab, hidden]`` in both.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.device import DEFAULT_DEVICE
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_paddle_tpu_params"]


@torch.no_grad()
def from_paddle_tpu_params(named: dict, config: LlamaConfig,
                           device=DEFAULT_DEVICE,
                           dtype=None) -> LlamaForCausalLM:
    """A port ``LlamaForCausalLM`` on `device` loaded from `named`
    ({paddle_tpu parameter name: np.ndarray}). Raises on a missing,
    unexpected or misshapen name."""
    model = LlamaForCausalLM(config, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named))
    extra = sorted(set(named) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for name, p in params.items():
        arr = np.asarray(named[name])
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            arr = arr.T                     # paddle [in, out] -> [out, in]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"fit {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, copy=True)))
    return model
