"""Sharded checkpoint load with resharding
(``paddle_tpu.distributed.checkpoint.load_state_dict`` counterpart;
reference: distributed/checkpoint/load_state_dict.py). Shards are
reassembled into the global array from the metadata, and a target tensor
takes its own part of it (``layout.local_part``: its mp shard, expert
block or ZeRO-3 range, else the whole array), so a checkpoint saved under
one parallel layout loads under another.

``read_global_state`` exposes the reconstruction directly (every key back
as a full CPU tensor): the elastic resume path (``elastic.py``) rebuilds a
training state saved under any layout with it."""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from paddle_tpu_torch.distributed.checkpoint import format as ckpt_format
from paddle_tpu_torch.distributed.checkpoint import layout

__all__ = ["load_state_dict", "read_global_state", "read_checkpoint",
           "reconstruct_global"]


def _flatten_tensors(sd, prefix=""):
    """Flat key -> (parent dict, leaf key, value), so non-tensor entries are
    assigned back through their nested location."""
    out = {}
    for k, v in sd.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten_tensors(v, key))
        else:
            out[key] = (sd, k, v)
    return out


def read_checkpoint(path):
    """(Metadata, shard_data) of a checkpoint directory. Legacy pickle
    files raise with a re-save pointer (format.reject_legacy_pickle)."""
    meta_files = sorted(glob.glob(os.path.join(path, "*.metadata")))
    if not meta_files:
        raise FileNotFoundError(f"no .metadata in {path}")
    from concurrent.futures import ThreadPoolExecutor

    meta = ckpt_format.read_metadata(meta_files[0])
    files = sorted(glob.glob(os.path.join(path, "*.distcp")))
    shard_data = {}
    # the files in parallel threads: reads and the zip CRC release the GIL
    with ThreadPoolExecutor(max(1, min(4, len(files)))) as ex:
        for part in ex.map(ckpt_format.read_shard_file, files):
            shard_data.update(part)
    return meta, shard_data


def reconstruct_global(metas, shard_data, key) -> torch.Tensor:
    """Reassemble one key's global array from its shards. Offsets and
    shapes come from the metadata, so a save under ANY layout reads back
    as the one logical array."""
    if (len(metas) == 1
            and metas[0].global_offset == (0,) * len(metas[0].local_shape)):
        return shard_data[(key, metas[0].global_offset)]
    gshape = [0] * len(metas[0].local_shape)
    for m in metas:
        for d in range(len(gshape)):
            gshape[d] = max(gshape[d], m.global_offset[d] + m.local_shape[d])
    arr = torch.zeros(gshape, dtype=ckpt_format.torch_dtype(metas[0].dtype))
    for m in metas:
        sl = tuple(slice(o, o + s)
                   for o, s in zip(m.global_offset, m.local_shape))
        arr[sl] = shard_data[(key, m.global_offset)]
    return arr


def read_global_state(path) -> dict:
    """Every saved key reconstructed to its full (unsharded) CPU tensor:
    the layout-free view elastic resume cuts for the target layout."""
    meta, shard_data = read_checkpoint(path)
    return {key: reconstruct_global(metas, shard_data, key)
            for key, metas in meta.state_dict_metadata.items()}


def load_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    unique_id=None, offload=False):
    """Load `path` into `state_dict` in place: a tensor entry (or a Paddle
    tensor's value) takes its part of the global array in its own dtype
    and device; any other entry is replaced by the global tensor."""
    meta, shard_data = read_checkpoint(path)
    for key, (parent, leaf, target) in _flatten_tensors(state_dict).items():
        if key not in meta.state_dict_metadata:
            continue
        arr = reconstruct_global(meta.state_dict_metadata[key], shard_data,
                                 key)
        t = getattr(target, "_value", target)
        if isinstance(t, torch.Tensor):
            part = layout.local_part(arr, t)
            dst = layout.storage(t)
            with torch.no_grad():
                dst.copy_(part.reshape(dst.shape).to(dst.dtype))
        elif isinstance(target, np.ndarray):
            parent[leaf] = arr.numpy()
        else:
            parent[leaf] = arr
    return state_dict
