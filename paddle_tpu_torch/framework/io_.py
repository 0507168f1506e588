"""``paddle.save`` / ``paddle.load`` (``paddle_tpu.framework.io_``
counterpart), in the JAX package's format: a pickle of the object tree
with each tensor replaced by ``{"__paddle_tpu_tensor__": True, "data":
ndarray, "stop_gradient": bool}``. A file either package writes loads in
the other, equal bit for bit.

What is a tensor here: the port's ``Tensor`` and any ``torch.Tensor``
(an ``nn.Module``'s state dict); ``save`` copies device tensors to the
host. ``load`` makes the port's ``Tensor``s on the current device (or
`place`), or returns the arrays with ``return_numpy=True``.

The small floats (bfloat16, float8_e4m3fn, float8_e5m2) are pickled as
the JAX package pickles them, as ``ml_dtypes`` arrays, whether or not
``ml_dtypes`` can be imported: without it the writer emits the same
opcodes itself. ``load`` without ``ml_dtypes`` gives them back as CPU
torch tensors of that dtype (with ``return_numpy=True``) or as
``Tensor``s, bit for bit.

Unlike the JAX package, ``load`` executes no code from the file: its
``Unpickler`` resolves only numpy's array, dtype and scalar
reconstruction, ``ml_dtypes``' small-float types and
``collections.OrderedDict``, and refuses any other global with a
``pickle.UnpicklingError`` naming it.
"""
from __future__ import annotations

import collections
import io
import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

_TENSOR_TAG = "__paddle_tpu_tensor__"

# torch dtype <-> the ml_dtypes type name of the floats numpy lacks
_SMALL = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
          torch.float8_e5m2: "float8_e5m2"}
_SMALL_BY_NAME = {v: k for k, v in _SMALL.items()}
_BITS = {1: np.uint8, 2: np.uint16}


def _ml_dtypes():
    """The ``ml_dtypes`` module, or None where it is not installed."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return ml_dtypes


def _reconstruct_fn():
    """numpy's ``_reconstruct`` (``numpy._core`` or ``numpy.core``)."""
    return np.ndarray.__reduce__(np.zeros(1, np.float32))[0]


# ---------------------------------------------------------------------------
# writing

class _SmallArray:
    """A small-float tensor's bits, to be pickled as an ``ml_dtypes``
    array by ``_Writer`` where ``ml_dtypes`` is absent."""

    def __init__(self, t: torch.Tensor):
        self.name = _SMALL[t.dtype]
        self.shape = tuple(t.shape)
        self.itemsize = t.element_size()
        bits = t.contiguous().view(torch.uint8 if self.itemsize == 1
                                   else torch.int16)
        self.raw = bits.numpy().tobytes()


class _SmallDtype:
    def __init__(self, name, itemsize):
        self.name, self.itemsize = name, itemsize


class _MlGlobal:
    def __init__(self, name):
        self.name = name


class _Writer(pickle._Pickler):
    """The pure-Python pickler, taught to write ``_SmallArray`` as numpy
    pickles an ``ml_dtypes`` array: ``_reconstruct(ndarray, (0,), b'b')``
    built from ``(1, shape, dtype(ml_dtypes.<name>, False, True), False,
    bits)``."""

    dispatch = dict(pickle._Pickler.dispatch)

    def _save_array(self, obj):
        self.save_reduce(_reconstruct_fn(), (np.ndarray, (0,), b"b"),
                         state=(1, obj.shape,
                                _SmallDtype(obj.name, obj.itemsize), False,
                                obj.raw), obj=obj)

    def _save_dtype(self, obj):
        self.save_reduce(np.dtype, (_MlGlobal(obj.name), False, True),
                         state=(3, "<", None, None, None, obj.itemsize,
                                obj.itemsize, 64), obj=obj)

    def _save_global(self, obj):
        self.save("ml_dtypes")
        self.save(obj.name)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    dispatch[_SmallArray] = _save_array
    dispatch[_SmallDtype] = _save_dtype
    dispatch[_MlGlobal] = _save_global


def _host_array(t: torch.Tensor, small: list):
    """A host array of `t`: numpy, an ``ml_dtypes`` array for a small
    float where ``ml_dtypes`` exists, else a ``_SmallArray``."""
    t = t.detach()
    if t.dtype in _SMALL:
        t = t.cpu()
        ml = _ml_dtypes()
        if ml is not None:
            bits = t.contiguous().view(torch.uint8 if t.element_size() == 1
                                       else torch.int16).numpy()
            return bits.view(getattr(ml, _SMALL[t.dtype]))
        small.append(True)
        return _SmallArray(t)
    return t.cpu().numpy()


def _pack(obj: Any, small: list):
    from paddle_tpu_torch.core.tensor import Tensor

    if isinstance(obj, Tensor):
        return {_TENSOR_TAG: True, "data": _host_array(obj._value, small),
                "stop_gradient": obj.stop_gradient}
    if isinstance(obj, torch.Tensor):
        return {_TENSOR_TAG: True, "data": _host_array(obj, small),
                "stop_gradient": not obj.requires_grad}
    if isinstance(obj, dict):
        return {k: _pack(v, small) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v, small) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def save(obj: Any, path: str, protocol: int = 4):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    small: list = []
    packed = _pack(obj, small)
    with open(path, "wb") as f:
        if small:
            _Writer(f, protocol=protocol).dump(packed)
        else:
            pickle.dump(packed, f, protocol=protocol)


# ---------------------------------------------------------------------------
# reading

class _SmallType:
    """Stands in for an ``ml_dtypes`` type where the module is absent."""

    def __init__(self, name):
        self.name = name


class _SmallDtypeStub:
    def __init__(self, name):
        self.name = name

    def __setstate__(self, state):
        pass


def _dtype(obj, align=False, copy=True):
    if isinstance(obj, _SmallType):
        return _SmallDtypeStub(obj.name)
    return np.dtype(obj, align, copy)


class _ArrayStub:
    """What ``_reconstruct`` returns while ``ml_dtypes`` is absent; BUILD
    hands it numpy's array state, and `value` is the array (a CPU torch
    tensor for a small float)."""

    def __init__(self, *args):
        self.value = None

    def __setstate__(self, state):
        _, shape, dt, fortran, raw = state
        order = "F" if fortran else "C"
        if isinstance(dt, _SmallDtypeStub):
            tdt = _SMALL_BY_NAME[dt.name]
            size = torch.empty((), dtype=tdt).element_size()
            bits = np.frombuffer(raw, _BITS[size]).reshape(shape, order=order)
            bits = np.array(bits, order="C")
            self.value = torch.from_numpy(
                bits.view(np.int16) if size == 2 else bits).view(tdt)
            return
        arr = np.frombuffer(raw, dt).reshape(shape, order=order)
        self.value = np.array(arr, order=order)


def _scalar(dt, raw):
    if isinstance(dt, _SmallDtypeStub):
        tdt = _SMALL_BY_NAME[dt.name]
        size = torch.empty((), dtype=tdt).element_size()
        bits = np.frombuffer(raw, _BITS[size]).copy()
        return torch.from_numpy(bits.view(np.int16) if size == 2
                                else bits).view(tdt).reshape(())
    return np.frombuffer(raw, dt)[0]


_NUMPY_MODULES = ("numpy._core.multiarray", "numpy.core.multiarray")


class _SafeUnpickler(pickle.Unpickler):
    """Resolves numpy's array/dtype/scalar reconstruction, ``ml_dtypes``'
    small floats and ``OrderedDict``; refuses every other global."""

    def __init__(self, f):
        super().__init__(f)
        self._ml = _ml_dtypes()

    def find_class(self, module, name):
        if module == "numpy" and name == "ndarray":
            return np.ndarray
        if module == "numpy" and name == "dtype":
            return np.dtype if self._ml is not None else _dtype
        if module in _NUMPY_MODULES and name == "_reconstruct":
            return _reconstruct_fn() if self._ml is not None else _ArrayStub
        if module in _NUMPY_MODULES and name == "scalar":
            return _scalar
        if module == "ml_dtypes" and name in _SMALL_BY_NAME:
            if self._ml is not None:
                return getattr(self._ml, name)
            return _SmallType(name)
        if module == "collections" and name == "OrderedDict":
            return collections.OrderedDict
        raise pickle.UnpicklingError(
            f"refusing to load global {module}.{name}: paddle_tpu_torch.load "
            f"resolves only numpy arrays, dtypes and scalars (and ml_dtypes' "
            f"small floats), since unpickling anything else can execute "
            f"code from the file")


def _unstub(obj):
    if isinstance(obj, _ArrayStub):
        return obj.value
    if isinstance(obj, dict):
        return type(obj)((k, _unstub(v)) for k, v in obj.items())
    if isinstance(obj, list):
        return [_unstub(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unstub(v) for v in obj)
    return obj


def _to_torch(data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data
    data = np.asarray(data)
    if data.dtype.name in _SMALL_BY_NAME:        # an ml_dtypes array
        size = data.dtype.itemsize
        bits = np.ascontiguousarray(data).view(np.int16 if size == 2
                                               else np.uint8)
        return torch.from_numpy(bits.copy()).view(
            _SMALL_BY_NAME[data.dtype.name])
    return torch.from_numpy(np.array(data))


def _unpack(obj: Any, return_numpy: bool, device):
    from paddle_tpu_torch.core.tensor import Tensor

    if isinstance(obj, dict):
        if obj.get(_TENSOR_TAG):
            if return_numpy:
                return obj["data"]
            return Tensor(_to_torch(obj["data"]).to(device),
                          stop_gradient=obj.get("stop_gradient", True))
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy, device) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy, device) for v in obj)
    return obj


def load(path: str, return_numpy: bool = False, place=None):
    """The object tree `path` holds, tensors as ``Tensor``s on `place`
    (the current device when None), or as arrays with `return_numpy`."""
    from paddle_tpu_torch.core.device import current_device

    with open(path, "rb") as f:
        obj = _unstub(_SafeUnpickler(io.BufferedReader(f)).load())
    device = None if return_numpy else current_device(place)
    return _unpack(obj, return_numpy, device)
