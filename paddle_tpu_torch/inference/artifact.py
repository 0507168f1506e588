"""The ``paddle_tpu-npz1`` container (``paddle_tpu.inference.artifact``
counterpart, byte for byte the same format): a zip holding

* ``meta.json``        — JSON metadata (format tag, per-param shape/dtype
                         table, and whatever keys the writer added, e.g.
                         a LoRA adapter's ``adapter`` block). Parsed with
                         `json.loads`.
* ``stablehlo.bin``    — the JAX package's serialized program, when the
                         writer had one. The port passes its bytes through
                         and never runs them.
* ``param_NNNNN.bin``  — each parameter's raw little-endian array bytes,
                         reshaped per the meta table. Never unpickled.

Parameters come back as numpy arrays, except the small floats
(``bfloat16``, ``float8_e4m3fn``, ``float8_e5m2``), which numpy lacks
without ``ml_dtypes``: those come back as CPU ``torch`` tensors of that
dtype, and the writer takes them as such. The bytes are the JAX package's
either way, so each package reads the other's files.
"""
from __future__ import annotations

import json
import zipfile

import numpy as np
import torch

__all__ = ["FORMAT_NAME", "write_artifact", "read_artifact",
           "SMALL_FLOATS"]

FORMAT_NAME = "paddle_tpu-npz1"

_META = "meta.json"
_PROGRAM = "stablehlo.bin"


# dtype names numpy has no type for: read and written as torch tensors
SMALL_FLOATS = {"bfloat16": torch.bfloat16,
                "float8_e4m3fn": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2}


def _raw(p):
    """(dtype name, shape, little-endian bytes) of a numpy array or a
    torch tensor."""
    if isinstance(p, torch.Tensor):
        t = p.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if name in SMALL_FLOATS:
            data = t.view(torch.uint8 if t.element_size() == 1
                          else torch.int16).numpy().tobytes()
        else:
            data = t.numpy().tobytes()
        return name, tuple(t.shape), data
    a = np.ascontiguousarray(np.asarray(p))
    return str(a.dtype), a.shape, a.tobytes()


def _from_raw(raw: bytes, dtype: str, shape):
    if dtype in SMALL_FLOATS:
        tdt = SMALL_FLOATS[dtype]
        carrier = np.uint8 if tdt.itemsize == 1 else np.int16
        arr = np.frombuffer(raw, dtype=carrier).reshape(shape).copy()
        return torch.from_numpy(arr).view(tdt)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def _param_name(i: int) -> str:
    return f"param_{i:05d}.bin"


def write_artifact(path: str, blob: dict) -> None:
    """Serialize a blob (params as numpy arrays or torch tensors, optional
    program bytes under 'stablehlo', JSON-able metadata) into the
    container. Metadata keys beyond 'stablehlo'/'params' pass through
    meta.json verbatim (they must be JSON-serializable)."""
    params = [_raw(p) for p in blob.get("params", [])]
    meta = {k: v for k, v in blob.items() if k not in ("stablehlo", "params")}
    meta["format"] = FORMAT_NAME
    meta["param_table"] = [
        {"shape": [int(d) for d in shape], "dtype": dtype}
        for dtype, shape, _ in params]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_META, json.dumps(meta))
        # program member is optional: LoRA adapter artifacts are pure data
        # (factors + 'adapter' meta block) against a shared base program
        if blob.get("stablehlo") is not None:
            z.writestr(_PROGRAM, bytes(blob["stablehlo"]))
        for i, (_, _, data) in enumerate(params):
            z.writestr(_param_name(i), data)


def _reject_legacy(path: str, head: bytes):
    if head[:1] == b"\x80":  # pickle protocol-2+ opcode PROTO
        raise ValueError(
            f"{path!r} is a legacy pickle .pdmodel artifact; pickles are "
            f"never loaded because unpickling executes arbitrary code from "
            f"the file. Re-export it as the '{FORMAT_NAME}' container: a "
            f"zip of meta.json + raw param_*.bin members.")


def read_artifact(path: str) -> dict:
    """Load a container written by `write_artifact` (of either package);
    returns the blob dict ('params' as numpy arrays or, for the small
    floats, CPU torch tensors; 'stablehlo' bytes when present; plus the
    metadata keys). Nothing in this path ever unpickles."""
    with open(path, "rb") as f:
        head = f.read(8)
    _reject_legacy(path, head)
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path!r} is not a '{FORMAT_NAME}' artifact (not a zip "
            f"container)")
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read(_META).decode("utf-8"))
        if meta.get("format") != FORMAT_NAME:
            raise ValueError(
                f"{path!r}: unsupported artifact format "
                f"{meta.get('format')!r}; expected '{FORMAT_NAME}'")
        table = meta.pop("param_table", [])
        meta.pop("format", None)
        params = []
        for i, entry in enumerate(table):
            params.append(_from_raw(z.read(_param_name(i)), entry["dtype"],
                                    [int(d) for d in entry["shape"]]))
        blob = dict(meta)
        if _PROGRAM in z.namelist():
            blob["stablehlo"] = z.read(_PROGRAM)
        blob["params"] = params
    return blob
