"""The ``paddle_tpu-dcp1`` checkpoint container
(``paddle_tpu.distributed.checkpoint.format`` counterpart, the same format
both ways): JSON metadata and raw array shards, nothing pickled.

* each rank's ``<rank>_<i>.distcp`` (one or a few a rank) is a zip
  holding

  - ``meta.json``       — the shard table: for every saved shard its
                          tensor key, global offset, local shape and dtype,
                          and the member that holds its bytes;
  - ``shard_NNNNN.bin`` — the shard's raw little-endian bytes.

* the ``<id>.metadata`` file is plain JSON (the merged global
  :class:`Metadata` of every rank's shard table).

Dtypes are named as the JAX package names them (``float32``, ``int64``,
``uint32``, ``bfloat16``, ``float8_e4m3fn``...), so each package reads
the other's files. Shards are written from CPU ``torch`` tensors or numpy
arrays and read back as CPU ``torch`` tensors (numpy lacks the small
floats without ``ml_dtypes``). Loaders REJECT legacy pickle checkpoints
with an error pointing at re-saving. ``fsync_file``/``fsync_dir`` serve the
elastic commit protocol, which needs shard bytes on disk before the rename
that publishes them.
"""
from __future__ import annotations

import json
import os
import time
import zipfile

import numpy as np
import torch

from paddle_tpu_torch.distributed.checkpoint.metadata import (
    LocalTensorIndex, LocalTensorMetadata, Metadata)

__all__ = [
    "FORMAT_NAME", "write_shard_file", "write_rank_files", "read_shard_file",
    "shard_table",
    "write_metadata", "read_metadata", "reject_legacy_pickle",
    "fsync_file", "fsync_dir", "torch_dtype", "dtype_name",
]

FORMAT_NAME = "paddle_tpu-dcp1"

_META = "meta.json"

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "uint32": torch.uint32,
           "bool": torch.bool}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a format dtype name."""
    if name not in _DTYPES:
        raise ValueError(f"checkpoint dtype {name!r} is not supported")
    return _DTYPES[name]


def dtype_name(v) -> str:
    """The format's name of a tensor's or array's dtype (JAX's names)."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return str(np.asarray(v).dtype)


def reject_legacy_pickle(path: str):
    """Raise on a pre-dcp1 pickle checkpoint file, pointing at re-saving.
    (pickle protocol 2+ streams start with the PROTO opcode 0x80.)"""
    with open(path, "rb") as f:
        head = f.read(2)
    if head[:1] == b"\x80":
        raise ValueError(
            f"{path!r} is a legacy pickle checkpoint; pickle loading was "
            f"removed from distributed/checkpoint because unpickling "
            f"executes arbitrary code from the file. Re-save the state dict "
            f"with the current save_state_dict to produce the safe "
            f"'{FORMAT_NAME}' container (zip of meta.json + raw "
            f"shard_*.bin members).")


def _member(i: int) -> str:
    return f"shard_{i:05d}.bin"


def _raw(v):
    """(dtype name, shape, byte view) of a CPU tensor or numpy array,
    without a copy where the value is contiguous."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        view = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else \
            np.zeros(0, np.uint8)
        return dtype_name(t), tuple(t.shape), memoryview(view)
    a = np.ascontiguousarray(np.asarray(v))
    return str(a.dtype), a.shape, memoryview(a.reshape(-1).view(np.uint8))


def write_shard_file(path: str, shards: dict, timings: dict | None = None,
                     fsync: bool = True):
    """Serialize ``{(key, global_offset): tensor or array}`` into one
    container; the bytes are flushed and (with `fsync`) fsync'd before it
    returns (the commit protocol renames this file's directory
    afterwards). `timings`, when given, gets ``bytes``, ``write_s`` and
    ``fsync_s``."""
    t0 = time.perf_counter()
    table, views = [], []
    for i, ((key, off), arr) in enumerate(sorted(shards.items(),
                                                 key=lambda kv: kv[0])):
        dt, shape, view = _raw(arr)
        table.append({"key": key, "offset": [int(o) for o in off],
                      "shape": [int(d) for d in shape], "dtype": dt,
                      "member": _member(i)})
        views.append(view)
    nbytes = 0
    with open(path, "wb") as f:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as z:
            z.writestr(_META, json.dumps({"format": FORMAT_NAME,
                                          "shards": table}))
            for entry, view in zip(table, views):
                info = zipfile.ZipInfo(entry["member"])
                info.file_size = view.nbytes   # zip64 where a member needs it
                with z.open(info, "w") as out:
                    out.write(view)
                nbytes += view.nbytes
        f.flush()
        t1 = time.perf_counter()
        if fsync:
            os.fsync(f.fileno())
    if timings is not None:
        timings["bytes"] = nbytes
        timings["write_s"] = t1 - t0
        timings["fsync_s"] = time.perf_counter() - t1


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(np.asarray(v).nbytes)


_RANK_FILES = 4        # a rank's containers, written by as many threads


def write_rank_files(dirpath: str, rank: int, shards: dict,
                     timings: dict | None = None,
                     min_file_bytes: int = 256 << 20) -> list:
    """One rank's shards as containers ``<rank>_<i>.distcp`` under
    `dirpath`: split by bytes into at most ``_RANK_FILES`` files of at
    least `min_file_bytes` each (one file for a small state), written in
    parallel threads (the zip CRC and the file writes release the GIL),
    then fsync'd in parallel. Each is a complete container, so every
    reader of the format (the JAX package's too) takes any number of
    files a rank. Returns the file names; `timings` gets ``bytes``,
    ``files``, ``write_s`` and ``fsync_s`` (wall time of each phase)."""
    from concurrent.futures import ThreadPoolExecutor

    items = sorted(shards.items(), key=lambda kv: -_nbytes(kv[1]))
    total = sum(_nbytes(v) for _, v in items)
    n = max(1, min(_RANK_FILES, len(items), total // min_file_bytes))
    bins, load = [dict() for _ in range(n)], [0] * n
    for k, v in items:                        # largest first, lightest bin
        i = load.index(min(load))
        bins[i][k] = v
        load[i] += _nbytes(v)
    names = [f"{rank}_{i}.distcp" for i in range(n)]
    paths = [os.path.join(dirpath, nm) for nm in names]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(n) as ex:
        list(ex.map(lambda i: write_shard_file(paths[i], bins[i],
                                               fsync=False), range(n)))
        t1 = time.perf_counter()
        list(ex.map(fsync_file, paths))
    if timings is not None:
        timings.update(bytes=total, files=n, write_s=t1 - t0,
                       fsync_s=time.perf_counter() - t1)
    return names


def _read_table(path: str, z: zipfile.ZipFile) -> list:
    meta = json.loads(z.read(_META).decode("utf-8"))
    if meta.get("format") != FORMAT_NAME:
        raise ValueError(
            f"{path!r}: unsupported checkpoint shard format "
            f"{meta.get('format')!r}; expected '{FORMAT_NAME}'")
    return meta["shards"]


def shard_table(path: str) -> list:
    """The shard table of one container WITHOUT reading array bytes (the
    coordinator merges these into the global Metadata at commit)."""
    reject_legacy_pickle(path)
    with zipfile.ZipFile(path) as z:
        return _read_table(path, z)


def read_shard_file(path: str) -> dict:
    """Load a container back into ``{(key, global_offset): CPU tensor}``.
    Legacy pickle files raise with a re-save pointer; nothing here ever
    unpickles. Each member's CRC is checked as it is read."""
    reject_legacy_pickle(path)
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path!r} is not a '{FORMAT_NAME}' checkpoint shard container")
    out = {}
    with zipfile.ZipFile(path) as z:
        for entry in _read_table(path, z):
            dt = torch_dtype(entry["dtype"])
            shape = [int(d) for d in entry["shape"]]
            size = z.getinfo(entry["member"]).file_size
            if size == 0:
                t = torch.empty(shape, dtype=dt)
            else:
                buf = bytearray(size)
                with z.open(entry["member"]) as f:
                    view = memoryview(buf)
                    got = 0
                    while got < size:
                        n = f.readinto(view[got:])
                        if not n:
                            raise ValueError(f"{path!r}: member "
                                             f"{entry['member']} is short")
                        got += n
                t = torch.frombuffer(buf, dtype=dt).reshape(shape)
            out[(entry["key"], tuple(int(o) for o in entry["offset"]))] = t
    return out


def write_metadata(path: str, meta: Metadata) -> None:
    """The global Metadata view as plain JSON (+fsync)."""
    doc = {
        "format": FORMAT_NAME,
        "state": {
            key: [{"offset": [int(o) for o in m.global_offset],
                   "shape": [int(d) for d in m.local_shape],
                   "dtype": m.dtype} for m in metas]
            for key, metas in meta.state_dict_metadata.items()
        },
        "storage": [
            {"key": idx.tensor_key,
             "offset": [int(o) for o in idx.global_offset], "file": fname}
            for idx, fname in meta.storage_metadata.items()
        ],
        "flat_mapping": {k: list(v) for k, v in meta.flat_mapping.items()},
    }
    with open(path, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())


def read_metadata(path: str) -> Metadata:
    reject_legacy_pickle(path)
    with open(path, "r") as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT_NAME:
        raise ValueError(
            f"{path!r}: unsupported checkpoint metadata format "
            f"{doc.get('format')!r}; expected '{FORMAT_NAME}'")
    meta = Metadata()
    for key, metas in doc.get("state", {}).items():
        meta.state_dict_metadata[key] = [
            LocalTensorMetadata(tuple(int(o) for o in m["offset"]),
                                tuple(int(d) for d in m["shape"]),
                                str(m["dtype"]))
            for m in metas]
    for ent in doc.get("storage", []):
        idx = LocalTensorIndex(ent["key"],
                               tuple(int(o) for o in ent["offset"]))
        meta.storage_metadata[idx] = ent["file"]
    meta.flat_mapping = {k: tuple(v)
                         for k, v in doc.get("flat_mapping", {}).items()}
    return meta


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Flush a directory entry (the rename itself) to disk. Some platforms
    refuse O_RDONLY on directories; the commit protocol treats that as
    best-effort."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
