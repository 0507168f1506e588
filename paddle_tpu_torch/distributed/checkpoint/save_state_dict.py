"""Sharded checkpoint save (``paddle_tpu.distributed.checkpoint.
save_state_dict`` counterpart; reference: distributed/checkpoint/
save_state_dict.py:104).

The JAX package writes each host's addressable shards of its global
arrays. The port runs a process per rank, and a rank holds plain local
tensors, so what it holds of each logical (global) array is described by a
``LocalShards``: boxes of the global array, each a global offset and a
tensor. A rank writes each box at its TRUE global offset:

* a replicated tensor at offset 0, by the lowest rank that holds it
  (``save_state_dict`` dedupes over the group; the elastic layer decides
  the writer from the rank's mesh coordinates);
* an mp shard (``mp_sharded`` with ``split_axis``) at ``mp_rank *
  local_size`` on its split axis, an expert block (``ep_sharded``) at
  ``ep_rank * local_size`` on dim 0;
* a contiguous element range of a tensor (a ZeRO-3 rank's part of a
  parameter in its unit's flat buffer, a ZeRO-1/2 rank's slice of a
  moment) as at most ``2 * ndim - 1`` rectangular boxes
  (``range_boxes``); the zero padding of the flat buffers is never
  written.

The JAX package's ``read_global_state`` therefore reads a port checkpoint
back as the full arrays, and the port's reads a JAX one. Shard bytes land
in the pickle-free ``paddle_tpu-dcp1`` container (``format.py``); the
ranks' metadata merge through ``torch.distributed.all_gather_object``, as
the reference's ``save_state_dict`` does.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from paddle_tpu_torch.distributed.checkpoint import format as ckpt_format
from paddle_tpu_torch.distributed.checkpoint.metadata import (
    LocalTensorIndex, LocalTensorMetadata, Metadata)

__all__ = ["save_state_dict", "collect_shards", "merge_metas",
           "LocalShards", "range_boxes"]


class LocalShards:
    """This rank's part of one logical array of `global_shape`: `boxes` is
    ``[(global_offset, tensor), ...]`` (possibly empty: the rank holds a
    copy some lower rank writes)."""

    __slots__ = ("boxes", "global_shape", "dtype")

    def __init__(self, boxes, global_shape, dtype: str):
        self.boxes = list(boxes)
        self.global_shape = tuple(int(d) for d in global_shape)
        self.dtype = dtype

    def map(self, fn) -> "LocalShards":
        """The same boxes with `fn` applied to each tensor."""
        return LocalShards([(o, fn(t)) for o, t in self.boxes],
                           self.global_shape, self.dtype)

    def __repr__(self):
        return (f"LocalShards({len(self.boxes)} boxes of "
                f"{self.global_shape} {self.dtype})")


def range_boxes(start: int, stop: int, shape) -> list:
    """Elements [start, stop) of a row-major array of `shape` as
    ``[(offset, box_shape, flat_start), ...]``: at most ``2 * ndim - 1``
    rectangular boxes, each contiguous in flat order from `flat_start`
    (the head of a partial row, whole rows, the tail of a partial row, on
    each axis in turn)."""
    shape = tuple(int(d) for d in shape)
    if stop <= start:
        return []
    if len(shape) <= 1:
        return [((start,), (stop - start,), start)]
    row = int(np.prod(shape[1:]))
    out = []

    def sub(i, a, e):
        # elements [a, e) of row i, as boxes of the row's sub-array
        for off, bshape, fs in range_boxes(a, e, shape[1:]):
            out.append(((i,) + off, (1,) + bshape, i * row + fs))

    i0, i1 = start // row, (stop - 1) // row
    if i0 == i1:
        sub(i0, start - i0 * row, stop - i0 * row)
        return out
    if start % row:
        sub(i0, start % row, row)
        i0 += 1
    tail = stop % row
    full_end = i1 if tail else i1 + 1
    if full_end > i0:
        out.append(((i0,) + (0,) * (len(shape) - 1),
                    (full_end - i0,) + shape[1:], i0 * row))
    if tail:
        sub(i1, 0, tail)
    return out


def merge_metas(metas):
    merged = Metadata()
    for m in metas:
        for key, lms in m.state_dict_metadata.items():
            dst = merged.state_dict_metadata.setdefault(key, [])
            for lm in lms:
                if not any(e.global_offset == lm.global_offset for e in dst):
                    dst.append(lm)
        for idx, fname in m.storage_metadata.items():
            merged.storage_metadata.setdefault(idx, fname)
    return merged


def _flatten(sd, prefix=""):
    out = {}
    for k, v in sd.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _value(v):
    """A paddle-API tensor's torch value, else `v`."""
    return getattr(v, "_value", v) if not isinstance(
        v, (torch.Tensor, np.ndarray, LocalShards)) else v


def collect_shards(flat: dict, fname: str):
    """(meta, data) for this rank's part of a flat ``key -> value`` dict: a
    ``LocalShards`` contributes one entry per box, a tensor or array one
    whole-array entry at offset zero. `data` maps (key, global_offset) ->
    tensor or array: exactly one container file's content. Shared by
    ``save_state_dict`` and the elastic writer."""
    meta = Metadata()
    data: dict = {}
    for key, val in flat.items():
        val = _value(val)
        if isinstance(val, LocalShards):
            metas = []
            for off, t in val.boxes:
                off = tuple(int(o) for o in off)
                if any(m.global_offset == off for m in metas):
                    continue
                metas.append(LocalTensorMetadata(off, tuple(t.shape),
                                                 val.dtype))
                meta.storage_metadata[LocalTensorIndex(key, off)] = fname
                data[(key, off)] = t
            if metas:
                meta.state_dict_metadata[key] = metas
            continue
        if not isinstance(val, torch.Tensor):
            val = np.asarray(val)
        off = (0,) * val.ndim
        meta.state_dict_metadata[key] = [LocalTensorMetadata(
            off, tuple(val.shape), ckpt_format.dtype_name(val))]
        meta.storage_metadata[LocalTensorIndex(key, off)] = fname
        data[(key, off)] = val
    return meta, data


def _group_pg(group):
    return getattr(group, "pg", group)


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    unique_id=None, async_save=False):
    """Write this rank's part of `state_dict` (nested dicts of tensors,
    ``LocalShards`` and arrays) under `path`: ``<rank>_0.distcp`` from
    every rank, the merged ``<unique_id or 0>.metadata`` from the
    coordinator. Every rank of `process_group` (default: all) calls it; a
    (key, offset) box two ranks hold is written by the lower one."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.env import get_rank, get_world_size

    os.makedirs(path, exist_ok=True)
    rank = get_rank()
    world = get_world_size(process_group)
    fname = f"{rank}_0.distcp"
    meta, data = collect_shards(_flatten(state_dict), fname)
    metas = [meta]
    if world > 1:
        # every rank's box table, in rank order (the reference's
        # all_gather_object); it is also the barrier before the
        # coordinator writes the metadata of files that exist
        metas = [None] * world
        dist.all_gather_object(metas, meta, group=_group_pg(process_group))
        for m in metas[:get_rank(process_group)]:
            for idx in m.storage_metadata:      # a lower rank writes it
                data.pop((idx.tensor_key, idx.global_offset), None)
        merged = merge_metas(metas)
    else:
        merged = meta
    ckpt_format.write_shard_file(os.path.join(path, fname), data)
    if world > 1:
        # the metadata names every rank's file: each must be on disk first
        dist.barrier(group=_group_pg(process_group))
    if rank == coordinator_rank:
        ckpt_format.write_metadata(
            os.path.join(path, f"{unique_id or 0}.metadata"), merged)
    if world > 1:
        dist.barrier(group=_group_pg(process_group))
