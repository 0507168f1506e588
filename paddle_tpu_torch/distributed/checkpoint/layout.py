"""Where a rank's tensor sits in its logical (global) array, for the
sharded save and load (the port's counterpart of a JAX array's
``addressable_shards``/``sharding``; no JAX module has one).

A parameter's local tensor is the whole logical array unless it is

* an mp shard (``mp_sharded``, ``split_axis``): block ``mp_rank`` of the
  split axis;
* an expert block (``ep_sharded``): block ``ep_rank`` of dim 0;
* a ZeRO-3 parameter (``_zero3 = (unit, bucket, index)``, which holds no
  data between uses): this rank's contiguous element range of the local
  tensor above, a view into its unit's shard.

``placement`` gives the local tensor's shape, the global shape, the local
tensor's global offset and the mesh axes the value differs along;
``writes`` says whether this rank is the lowest of the ranks holding the
same value (the one that writes it). The coordinates come from the fleet
hcg when one is built, else from the rank mesh, else every rank but 0
holds a replica.

The JAX package stores a linear weight ``[in, out]``, the port's
PyTorch-layout models ``[out, in]``: a module whose class sets
``torch_linear_layout`` (or a ``torch.nn.Linear``) has its
``*_proj.weight`` and ``lm_head.weight`` entries (and their optimizer
slots) saved and loaded transposed (``jax_transposed``), so a snapshot
holds the JAX package's names and layout either way.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["hcg", "coords", "placement", "writes", "local_part",
           "zero3_range", "storage", "unwrap", "jax_transposed", "torch_layout",
           "is_linear_name"]

def hcg():
    """The fleet hcg when one is built, else None (never builds one)."""
    from paddle_tpu_torch.distributed import fleet

    return fleet._hcg[0]


def coords(h=None) -> dict:
    """{axis: (rank, degree)} of this process on the hcg's axes; before an
    hcg is built, on the rank mesh's (``build_mesh``); without either, a
    world of replicas over "dp"."""
    h = h if h is not None else hcg()
    if h is None:
        from paddle_tpu_torch.distributed.env import (get_rank,
                                                      get_world_size)
        from paddle_tpu_torch.distributed.mesh import get_mesh

        mesh = get_mesh()
        if mesh is None:
            return {"dp": (get_rank(), get_world_size())}
        c = mesh.coord()
        return {ax: (int(c[ax]), int(n)) for ax, n in mesh.shape.items()}
    return {
        "dp": (h.get_data_parallel_rank(), h.get_data_parallel_world_size()),
        "sharding": (h.get_sharding_parallel_rank(),
                     h.get_sharding_parallel_world_size()),
        "mp": (h.get_model_parallel_rank(),
               h.get_model_parallel_world_size()),
        "pp": (h.get_stage_id(), h.get_pipe_parallel_world_size()),
        "sep": (h.get_sep_parallel_rank(), h.get_sep_parallel_world_size()),
        "ep": (h.get_expert_parallel_rank(),
               h.get_expert_parallel_world_size())}


def writes(split, c=None) -> bool:
    """True when this rank is the lowest holder of a value that differs
    along the axes `split` only (coordinate 0 on every other axis)."""
    c = c if c is not None else coords()
    return all(r == 0 for ax, (r, _) in c.items() if ax not in split)


def zero3_range(p):
    """(start, stop) of a ZeRO-3 parameter's elements this rank holds, in
    its local tensor's flat order, or None for another parameter."""
    mark = getattr(p, "_zero3", None)
    if mark is None:
        return None
    u, bi, i = mark
    b = u.buckets[bi]
    a, e = b.ranges[i]
    lo = u.sharder.group.rank * b.per - b.offsets[i]
    return lo + a, lo + e


def placement(p, c=None):
    """(local shape, global shape, global offset of the local tensor, set
    of axes it differs along) of parameter `p` (see the module
    docstring)."""
    c = c if c is not None else coords()
    mark = getattr(p, "_zero3", None)
    if mark is not None:
        u, bi, i = mark
        shape = tuple(u.buckets[bi].shapes[i])
    else:
        shape = tuple(p.shape)
    gshape, base, split = list(shape), [0] * len(shape), set()
    if getattr(p, "mp_sharded", False) is True and c.get("mp", (0, 1))[1] > 1:
        r, n = c["mp"]
        ax = int(getattr(p, "split_axis", 0))
        base[ax], gshape[ax] = r * shape[ax], shape[ax] * n
        split.add("mp")
    if getattr(p, "ep_sharded", False) is True and c.get("ep", (0, 1))[1] > 1:
        r, n = c["ep"]
        base[0], gshape[0] = r * shape[0], shape[0] * n
        split.add("ep")
    if mark is not None:
        split.add("sharding")
    return shape, tuple(gshape), tuple(base), split


def local_part(full: torch.Tensor, p, c=None) -> torch.Tensor:
    """This rank's part of the global array `full` for parameter `p`: its
    mp shard or expert block, and for a ZeRO-3 parameter its element range
    (flat); else `full` itself."""
    shape, gshape, base, _ = placement(p, c)
    if tuple(full.shape) != gshape:
        raise ValueError(f"global array of shape {tuple(full.shape)} does "
                         f"not fit a parameter of global shape {gshape}")
    sl = tuple(slice(o, o + s) for o, s in zip(base, shape))
    out = full[sl] if any(o for o in base) or shape != gshape else full
    rng = zero3_range(p)
    if rng is not None:
        out = out.reshape(-1)[rng[0]:rng[1]]
    return out


def storage(p) -> torch.Tensor:
    """The tensor that holds `p`'s values on this rank: its slice of the
    unit's shard for a ZeRO-3 parameter, else `p`."""
    mark = getattr(p, "_zero3", None)
    if mark is None:
        return p
    u, bi, i = mark
    return u.buckets[bi].slices[i]


def unwrap(module):
    """The plain model inside the fleet and sharding wrappers."""
    while isinstance(getattr(module, "_layers", None), nn.Module):
        module = module._layers
    return module


def is_linear_name(name: str) -> bool:
    return name.endswith("_proj.weight") or name.endswith("lm_head.weight")


def torch_layout(module) -> bool:
    """True for a module whose linear weights are ``[out, in]``: a class
    that sets ``torch_linear_layout``, or a ``torch.nn.Linear``."""
    m = unwrap(module)
    return bool(getattr(m, "torch_linear_layout", False)) or isinstance(
        m, nn.Linear)


def jax_transposed(module, name: str) -> bool:
    """True for the entry `name` (its canonical or module-relative name)
    of `module` that the JAX package stores transposed."""
    return torch_layout(module) and is_linear_name(name)
