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
``state_dict()`` the same way, so a resumed port step matches the JAX one:
the per-parameter states of every optimizer (a linear's moments, masters
and ASGD's gradient window transposed), the step, an LR scheduler's
state (``LR_Scheduler``), LBFGS's flat history vectors (re-ordered into the
port's layout) and LookAhead's slow weights. ``fp8_state_from_paddle_tpu``
carries a ``CompiledTrainStep.fp8_state_dict()`` into ``TrainStep``'s
layout (a scanned group's ``[L, H]`` histories unstacked layer by layer). ``lora_from_paddle_tpu`` carries a
JAX LoRA adapter's factors onto the port's attached adapter (they keep the
JAX layout, A [in, r] and B [r, out]; the serving ``AdapterStore`` reads a
JAX-written adapter file itself).

Under tensor parallelism (an hcg or rank mesh with mp > 1) a LLaMA holds
its rank's shards: ``shard_paddle_tpu_params`` cuts the JAX package's
full parameters into mp rank r's shards (PyTorch layout: q, k, v, gate,
up, the head and the embedding by rows, o and down by columns, the norms
whole), ``from_paddle_tpu_params`` loads them into a model built under
the hcg, and ``gather_paddle_tpu_params`` puts the mp ranks' shards back
together into the full, JAX-layout state.
A single tensor-parallel layer (``ColumnParallelLinear``,
``RowParallelLinear`` and their sequence-parallel kin) takes its rank's
shard of a JAX layer's full ``[in, out]`` weight from ``shard_linear``,
and ``gather_linear`` puts the ranks' shards back.

Under pipeline parallelism a rank holds its stage's layers only, named
by their index in ``LlamaForCausalLM.pipeline_layers`` (0 the embedding,
1..L the decoder layers, L+1 the final norm with the head):
``pipeline_stage_params`` takes the JAX model's named parameters and
returns one stage's share, renamed (``llama_pipeline_name``) and cut to
mp rank r's shards; ``load_pipeline_params`` copies such a share into a
``PipelineLayer`` or into stage modules keyed by their index;
``gather_pipeline_params`` puts every stage's (and mp rank's) share back
together into the JAX names and layout.

Under expert parallelism (a rank mesh with an "ep" axis) a GPT-MoE
rank holds E/ep experts a layer: ``shard_expert_params`` cuts the full
parameters into ep rank r's share (the expert tensors' block of dim 0,
the rest whole), ``from_paddle_tpu_params`` does so itself for a model
built under the mesh, and ``gather_expert_params`` concatenates the ep
ranks' blocks back.

Models written on the Paddle API (``models/gpt.py``) keep Paddle's layout
in both packages, so their weights move name for name:
``state_from_paddle_tpu`` reads a JAX ``Layer`` (or its ``state_dict()``)
as numpy arrays, which the port ``Layer``'s ``set_state_dict`` loads.
Optimizer state then starts empty on both sides.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.device import DEFAULT_DEVICE
from paddle_tpu_torch.models.gpt_moe import GptMoeConfig, GptMoeForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_paddle_tpu_params", "optimizer_state_from_paddle_tpu",
           "fp8_state_from_paddle_tpu", "lora_from_paddle_tpu",
           "state_from_paddle_tpu", "shard_paddle_tpu_params",
           "gather_paddle_tpu_params", "mp_split_axis", "shard_linear",
           "gather_linear",
           "llama_pipeline_name", "pipeline_stage_params",
           "load_pipeline_params", "gather_pipeline_params",
           "is_expert_param", "shard_expert_params", "gather_expert_params"]

_COLUMN = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
           "gate_proj.weight", "up_proj.weight")
_ROW = ("o_proj.weight", "down_proj.weight")


def _to_port_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if _is_linear(name):
        return arr.T                        # paddle [in, out] -> [out, in]
    return arr


def _is_linear(name: str) -> bool:
    return name.endswith("_proj.weight") or name == "lm_head.weight"


def mp_split_axis(name: str):
    """The dim of LLaMA parameter `name` (PyTorch layout) that splits over
    mp, or None for a replicated one."""
    if name.endswith(_COLUMN) or name in ("lm_head.weight",
                                          "llama.embed_tokens.weight"):
        return 0
    if name.endswith(_ROW):
        return 1
    return None


def shard_paddle_tpu_params(named: dict, mp_rank: int, mp_degree: int):
    """{name: mp rank `mp_rank`'s shard in PyTorch layout} of the JAX
    package's full LLaMA parameters `named` (numpy, JAX layout): each
    split dim cut into `mp_degree` contiguous blocks."""
    out = {}
    for name, arr in named.items():
        arr = _to_port_layout(name, np.asarray(arr))
        ax = mp_split_axis(name) if mp_degree > 1 else None
        if ax is not None:
            n = arr.shape[ax]
            if n % mp_degree:
                raise ValueError(f"{name}: dim {ax} ({n}) is not a multiple "
                                 f"of the mp degree {mp_degree}")
            k = n // mp_degree
            arr = np.take(arr, range(mp_rank * k, (mp_rank + 1) * k),
                          axis=ax)
        out[name] = arr
    return out


def gather_paddle_tpu_params(shards) -> dict:
    """The full JAX-layout parameters from the mp ranks' shards: `shards`
    is one {name: array or tensor, PyTorch layout} a mp rank, in rank
    order (numpy or torch; the result is numpy)."""
    def as_np(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy() \
                if v.dtype == torch.bfloat16 else v.detach().cpu().numpy()
        return np.asarray(v)

    out = {}
    for name in shards[0]:
        ax = mp_split_axis(name) if len(shards) > 1 else None
        full = (as_np(shards[0][name]) if ax is None else
                np.concatenate([as_np(s[name]) for s in shards], axis=ax))
        out[name] = full.T if _is_linear(name) else full
    return out


def shard_linear(kind: str, mp_rank: int, mp_degree: int, weight,
                 bias=None) -> dict:
    """mp rank `mp_rank`'s {"weight"[, "bias"]} (numpy, PyTorch layout) of
    a JAX linear layer's full ``[in, out]`` weight and ``[out]`` bias:
    `kind` "column" (``ColumnParallelLinear``,
    ``ColumnSequenceParallelLinear``) takes rows ``[r out/mp, (r+1)
    out/mp)`` of ``[out, in]`` and the same block of the bias; "row"
    (``RowParallelLinear``, ``RowSequenceParallelLinear``) takes columns
    ``[r in/mp, (r+1) in/mp)`` and the whole bias."""
    if kind not in ("column", "row"):
        raise ValueError(f"kind {kind!r}: expected 'column' or 'row'")
    w = np.asarray(weight).T
    ax = 0 if kind == "column" else 1
    n = w.shape[ax]
    if n % mp_degree:
        raise ValueError(f"{kind} weight: dim {ax} ({n}) is not a multiple "
                         f"of the mp degree {mp_degree}")
    k = n // mp_degree
    part = slice(mp_rank * k, (mp_rank + 1) * k)
    out = {"weight": np.ascontiguousarray(w[part] if ax == 0
                                          else w[:, part])}
    if bias is not None:
        b = np.asarray(bias)
        out["bias"] = np.ascontiguousarray(b[part] if kind == "column"
                                           else b)
    return out


def gather_linear(kind: str, shards) -> dict:
    """The full JAX-layout {"weight" [in, out][, "bias"]} from the mp
    ranks' ``shard_linear`` dicts (or the layers' state dicts), in rank
    order; numpy out."""
    def as_np(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        return np.asarray(v)

    ax = 0 if kind == "column" else 1
    out = {"weight": np.concatenate([as_np(sh["weight"]) for sh in shards],
                                    axis=ax).T}
    if shards[0].get("bias") is not None:
        out["bias"] = (np.concatenate([as_np(sh["bias"]) for sh in shards])
                       if kind == "column" else as_np(shards[0]["bias"]))
    return out


_EXPERT = (".experts.w1", ".experts.w2", ".experts.b1", ".experts.b2")


def is_expert_param(name: str) -> bool:
    """A GPT-MoE (or ``MoELayer``) expert tensor: its dim 0 is the experts,
    split over ep."""
    return name.endswith(_EXPERT) or name in tuple(e[1:] for e in _EXPERT)


def shard_expert_params(named: dict, ep_rank: int, ep_degree: int) -> dict:
    """{name: array} of ep rank `ep_rank`'s share of the JAX package's full
    parameters `named` (numpy, JAX layout, kept): each expert tensor's
    block [ep_rank * E/ep, (ep_rank + 1) * E/ep) of dim 0, every other
    parameter whole."""
    out = {}
    for name, arr in named.items():
        arr = np.asarray(arr)
        if ep_degree > 1 and is_expert_param(name):
            n = arr.shape[0]
            if n % ep_degree:
                raise ValueError(f"{name}: {n} experts do not split over ep "
                                 f"{ep_degree}")
            k = n // ep_degree
            arr = arr[ep_rank * k:(ep_rank + 1) * k]
        out[name] = arr
    return out


def gather_expert_params(shards) -> dict:
    """The full parameters from the ep ranks' shares: `shards` is one
    {name: array or tensor} an ep rank, in ep-rank order (the layout as
    it is; numpy out): the expert tensors concatenated along dim 0, the
    others taken from the first share."""
    def as_np(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return np.asarray(v)

    return {name: (np.concatenate([as_np(s[name]) for s in shards])
                   if is_expert_param(name) else as_np(shards[0][name]))
            for name in shards[0]}


def llama_pipeline_name(name: str, num_layers: int) -> str:
    """The ``PipelineLayer`` name of LLaMA parameter `name` (the JAX
    package's ``LlamaForCausalLM`` name): ``llama.embed_tokens.weight`` ->
    ``0.embed_tokens.weight``, ``llama.layers.i.<rest>`` ->
    ``<i+1>.<rest>``, ``llama.norm.weight`` and ``lm_head.weight`` ->
    ``<L+1>.norm.weight`` and ``<L+1>.lm_head.weight``."""
    if name == "llama.embed_tokens.weight":
        return "0.embed_tokens.weight"
    if name.startswith("llama.layers."):
        i, rest = name[len("llama.layers."):].split(".", 1)
        return f"{int(i) + 1}.{rest}"
    if name == "llama.norm.weight":
        return f"{num_layers + 1}.norm.weight"
    if name == "lm_head.weight":
        return f"{num_layers + 1}.lm_head.weight"
    raise KeyError(f"{name} is no LLaMA parameter")


def _jax_name(pname: str, num_layers: int) -> str:
    """The inverse of ``llama_pipeline_name``."""
    i, rest = pname.split(".", 1)
    i = int(i)
    if i == 0:
        return f"llama.{rest}"
    if i == num_layers + 1:
        return f"llama.{rest}" if rest.startswith("norm.") else rest
    return f"llama.layers.{i - 1}.{rest}"


def pipeline_stage_params(named: dict, num_layers: int, indices,
                          mp_rank: int = 0, mp_degree: int = 1) -> dict:
    """{pipeline name: array (PyTorch layout, mp rank `mp_rank`'s shard)}
    of the layers at `indices` (their positions in
    ``LlamaForCausalLM.pipeline_layers``) from the JAX model's named
    parameters `named` (numpy, JAX layout)."""
    want = {int(i) for i in indices}
    mine = {n: a for n, a in named.items()
            if int(llama_pipeline_name(n, num_layers).split(".")[0]) in want}
    return {llama_pipeline_name(n, num_layers): a for n, a in
            shard_paddle_tpu_params(mine, mp_rank, mp_degree).items()}


@torch.no_grad()
def load_pipeline_params(target, stage_named: dict) -> None:
    """Copy a ``pipeline_stage_params`` share into `target`: a
    ``PipelineLayer`` (its parameters named by layer index), or a dict
    {layer index: module}. Raises on a missing or misshapen name."""
    if isinstance(target, dict):
        params = {f"{i}.{n}": p for i, mod in target.items()
                  for n, p in mod.named_parameters()}
    else:
        params = dict(target.named_parameters())
    missing = sorted(set(params) - set(stage_named))
    if missing:
        raise KeyError(f"no values for {missing[:5]}")
    for name, p in params.items():
        arr = np.asarray(stage_named[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"fit {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, copy=True)))


def gather_pipeline_params(stages, num_layers: int) -> dict:
    """The full JAX-named, JAX-layout parameters from every stage's share:
    `stages` holds, for each pp stage, its mp ranks' {pipeline name:
    tensor or array} in mp-rank order (one dict a stage without mp)."""
    out = {}
    for shards in stages:
        shards = shards if isinstance(shards, (list, tuple)) else [shards]
        renamed = [{_jax_name(n, num_layers): v for n, v in sh.items()}
                   for sh in shards]
        out.update(gather_paddle_tpu_params(renamed))
    return out


@torch.no_grad()
def from_paddle_tpu_params(named: dict, config: LlamaConfig | GptMoeConfig,
                           device=DEFAULT_DEVICE, dtype=None):
    """A port ``LlamaForCausalLM`` (or ``GptMoeForCausalLM`` for a
    ``GptMoeConfig``) on `device` loaded from `named` ({paddle_tpu
    parameter name: np.ndarray}). A LLaMA built under tensor parallelism
    (mp > 1) loads its rank's shards (``shard_paddle_tpu_params``), a
    GPT-MoE built under expert parallelism its block of each full expert
    tensor (``shard_expert_params``; a share already cut loads as it is).
    Raises on a missing, unexpected or misshapen name."""
    cls = (GptMoeForCausalLM if isinstance(config, GptMoeConfig)
           else LlamaForCausalLM)
    model = cls(config, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named))
    extra = sorted(set(named) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    group = getattr(model, "mp_group", None)
    port = (shard_paddle_tpu_params(named, group.rank, group.nranks)
            if group is not None else None)
    moe = (model.moe_layers() if isinstance(model, GptMoeForCausalLM)
           else [])
    if moe and moe[0].ep_degree > 1:
        # an ep rank keeps its block of each full expert tensor
        full = {n: a for n, a in named.items() if is_expert_param(n)
                and np.asarray(a).shape[0] != params[n].shape[0]}
        named = {**named, **shard_expert_params(full, moe[0].ep_rank,
                                                moe[0].ep_degree)}
    for name, p in params.items():
        arr = (port[name] if port is not None
               else _to_port_layout(name, np.asarray(named[name])))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"fit {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, copy=True)))
    return model


def _state_to_port(name: str, key: str, arr: np.ndarray, shape) -> np.ndarray:
    """One state entry in the port's layout: a linear's per-element state
    transposed on its last two axes (ASGD's ``ys`` window keeps its
    leading axis); scalars (NAdam's ``mu_prod``) as they are."""
    if arr.ndim >= 2 and _is_linear(name):
        arr = np.swapaxes(arr, -1, -2)
    if arr.ndim and tuple(arr.shape[arr.ndim - len(shape):]) != tuple(shape):
        raise ValueError(f"{name}.{key}: shape {tuple(arr.shape)} does not "
                         f"fit {tuple(shape)}")
    return arr


def _flat_to_port(vec, names, shapes, order):
    """A flat vector over the JAX optimizer's parameters (JAX layouts, in
    its order) re-cut into the port's layouts in the port's `order`."""
    parts, ofs = {}, 0
    for n, shp in zip(names, shapes):
        size = int(np.prod(shp))
        piece = np.asarray(vec[ofs:ofs + size]).reshape(shp)
        parts[n] = (piece.T if _is_linear(n) else piece).reshape(-1)
        ofs += size
    return np.concatenate([parts[n] for n in order]) if order else \
        np.zeros(0, np.float32)


def optimizer_state_from_paddle_tpu(state: dict, names, model,
                                    optimizer) -> None:
    """Load a paddle_tpu optimizer's ``state_dict()`` into the port's
    `optimizer` over `model` (a port optimizer, or ``LookAhead`` around
    one). ``names[i]`` is the parameter name of the JAX optimizer's i-th
    parameter (``[n for n, _ in jax_model.named_parameters()]`` when it was
    built from ``jax_model.parameters()``). Raises on a name the port model
    lacks or a misshapen entry."""
    port_name = {id(p): n for n, p in model.named_parameters()}
    jax_index = {n: i for i, n in enumerate(names)}
    inner = getattr(optimizer, "inner_optimizer", optimizer)
    params = inner._params
    order = []
    for j, p in enumerate(params):
        name = port_name.get(id(p))
        if name is None or name not in jax_index:
            raise KeyError(f"optimizer parameter {j} ({name}) has no "
                           f"paddle_tpu counterpart")
        order.append(name)
    out = {"step": int(state.get("step", 0))}
    if "LR_Scheduler" in state:
        out["LR_Scheduler"] = dict(state["LR_Scheduler"])
    for j, (p, name) in enumerate(zip(params, order)):
        saved = state.get(f"param_{jax_index[name]}")
        if saved is not None:
            out[f"param_{j}"] = {
                k: _state_to_port(name, k, np.asarray(v), p.shape)
                for k, v in saved.items()}
    if "lbfgs" in state:
        port_params = dict(model.named_parameters())
        jax_shapes = [tuple(reversed(port_params[n].shape)) if _is_linear(n)
                      else tuple(port_params[n].shape) for n in names]
        lb = state["lbfgs"]

        def flat(v):
            return None if v is None else _flat_to_port(v, names, jax_shapes,
                                                        order)

        out["lbfgs"] = {"s": [flat(v) for v in lb["s"]],
                        "y": [flat(v) for v in lb["y"]],
                        "rho": list(lb["rho"]),
                        "prev_flat": flat(lb["prev_flat"]),
                        "prev_grad": flat(lb["prev_grad"])}
    if "slow_params" in state:
        slow = state["slow_params"]
        out["slow_params"] = [
            np.asarray(slow[jax_index[n]]).T if _is_linear(n)
            else np.asarray(slow[jax_index[n]]) for n in order]
        out["lookahead_step"] = int(state.get("lookahead_step", 0))
    optimizer.set_state_dict(out)


def fp8_state_from_paddle_tpu(snap):
    """A ``CompiledTrainStep.fp8_state_dict()`` snapshot in ``TrainStep``'s
    layout: plain callsites as they are, each scanned group ``("scan", L,
    k)``'s k stacked ``[L, H]`` states unstacked into L x k plain ones,
    layer by layer (the order the unrolled layers meet them). None passes
    through."""
    if snap is None:
        return None
    states, pos = [], 0
    for entry in snap["layout"]:
        if entry[0] == "plain":
            states.append({k: np.asarray(v)
                           for k, v in snap["states"][pos].items()})
            pos += 1
            continue
        n_layers, k = int(entry[1]), int(entry[2])
        group = snap["states"][pos:pos + k]
        pos += k
        for layer in range(n_layers):
            states.extend({key: np.asarray(st[key])[layer] for key in st}
                          for st in group)
    return {"layout": [("plain",)] * len(states), "states": states}


def lora_from_paddle_tpu(handle_or_blob, model):
    """Load a paddle_tpu LoRA adapter's factors into the port adapter
    attached to `model` (by ``lora.attach``; `model` may also be that
    handle). The source is a JAX ``LoRAAdapter`` handle (its entries' A
    and B read as numpy arrays) or a ``load_adapter()`` blob of either
    package. Rank, target paths and factor shapes must match. Returns the
    port handle."""
    from paddle_tpu_torch.lora.adapter import LoRAAdapter

    if isinstance(handle_or_blob, dict):
        blob = handle_or_blob
    else:
        h = handle_or_blob
        blob = {"adapter": {"rank": int(h.config.rank)},
                "weights": {path: (np.asarray(a._value), np.asarray(b._value))
                            for path, _, a, b in h.entries}}
    port = (model if isinstance(model, LoRAAdapter)
            else getattr(model, "_lora_adapter", None))
    if port is None:
        raise ValueError("no LoRA adapter is attached to the port model; "
                         "lora.attach() one first")
    port.load_weights(blob)
    return port


def state_from_paddle_tpu(layer_or_state) -> dict:
    """{structured name: np.ndarray} of a paddle_tpu ``Layer`` (its
    ``state_dict()``) or of such a state dict, names and layout as they
    are (a bfloat16 tensor gives an ``ml_dtypes`` bfloat16 array, which
    ``to_tensor`` and ``set_state_dict`` read)."""
    state = (layer_or_state.state_dict()
             if hasattr(layer_or_state, "state_dict") else layer_or_state)
    return {name: np.asarray(getattr(v, "_value", v))
            for name, v in state.items()}
