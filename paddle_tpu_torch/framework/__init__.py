"""Framework glue (``paddle_tpu.framework`` counterpart): ``save``/``load``,
the default dtype, the build queries, ``iinfo``/``finfo``, the RNG state
of the port's explicit generators, print options and ``LazyGuard``."""
from paddle_tpu_torch.core.flags import get_flags, set_flags  # noqa: F401
from paddle_tpu_torch.framework.io_ import load, save  # noqa: F401
from paddle_tpu_torch.ops.random_state import (  # noqa: F401
    default_generator, seed)

__all__ = ["load", "save", "get_flags", "set_flags", "seed",
           "default_generator", "get_default_dtype", "set_default_dtype",
           "in_dynamic_mode", "is_compiled_with_cuda",
           "is_compiled_with_rocm", "is_compiled_with_xpu",
           "is_compiled_with_cinn", "is_compiled_with_custom_device",
           "iinfo", "finfo", "get_rng_state", "set_rng_state",
           "get_cuda_rng_state", "set_cuda_rng_state", "set_printoptions",
           "LazyGuard"]


def get_default_dtype():
    from paddle_tpu_torch.core.dtype import get_default_dtype as g

    return g()


def set_default_dtype(d):
    from paddle_tpu_torch.core.dtype import set_default_dtype as s

    return s(d)


def in_dynamic_mode():
    return True


def is_compiled_with_cuda():
    """True where the card is usable (CUDA is the port's device)."""
    from paddle_tpu_torch.core.device import is_compiled_with_cuda as c

    return c()


def is_compiled_with_rocm():
    return False


def is_compiled_with_xpu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_custom_device(device_type: str):
    """The port has no custom device: the card is CUDA."""
    return False


class iinfo:
    def __init__(self, dtype):
        import torch

        from paddle_tpu_torch.core.dtype import to_torch_dtype

        info = torch.iinfo(to_torch_dtype(dtype))
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = info.bits
        self.dtype = str(info.dtype)


class finfo:
    def __init__(self, dtype):
        import torch

        from paddle_tpu_torch.core.dtype import to_torch_dtype

        dt = to_torch_dtype(dtype)
        info = torch.finfo(dt)
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.tiny)
        # numpy keeps it in the dtype itself: 1e-3 as float16 is 0.0010004
        self.resolution = float(torch.tensor(info.resolution, dtype=dt))
        self.bits = info.bits
        self.dtype = str(info.dtype)


def get_rng_state(device=None):
    """The global generator's state, in a list (one entry, as the JAX
    package returns): its seed and each device generator's state."""
    return [default_generator.get_state()]


def set_rng_state(state_list, device=None):
    default_generator.set_state(state_list[0])


get_cuda_rng_state = get_rng_state
set_cuda_rng_state = set_rng_state


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor printing options: numpy's print options, which
    ``Tensor.__repr__`` uses."""
    import numpy as np

    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


class LazyGuard:
    """Defers nothing: parameters are made at construction (kept for the
    Paddle API's source compatibility)."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
