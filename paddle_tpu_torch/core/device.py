"""Device resolution and the Paddle-API places (``paddle_tpu.core.device``
counterpart).

The port's entry points take an explicit ``device`` and default to
``"cuda"``. They run on the CPU only when the caller asks for it
(``device="cpu"``, as the CPU tests do); a CUDA request on a machine
without CUDA raises instead of carrying on on the CPU.

The Paddle API (``Tensor``, ``to_tensor``, layers, creation ops) places
tensors on the current device: the card (``"gpu"``, Paddle's name for a
CUDA device) unless ``set_device("cpu")`` was called. ``CUDAPlace`` is the
port's counterpart of the JAX package's ``TPUPlace``. The current device is
process-wide (the JAX package keeps it per thread): autograd runs a CUDA
backward on its own thread, and tensors made there land on the same card.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE", "Place", "CPUPlace",
           "CUDAPlace", "set_device", "get_device", "current_place",
           "current_device", "device_count", "synchronize",
           "is_compiled_with_cuda"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for `device` ("cuda", "cuda:1", "cpu" or a
    ``torch.device``); raises RuntimeError when CUDA is asked for and
    absent, and ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                f"pass device='cpu' to run the port's plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device!r}")
    return dev


class Place:
    """A device place: ``"gpu"`` or ``"cpu"`` and an ordinal."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))

    def is_gpu_place(self):
        return self.device_type == "gpu"

    def is_cpu_place(self):
        return self.device_type == "cpu"


def CUDAPlace(device_id: int = 0) -> Place:
    return Place("gpu", device_id)


def CPUPlace() -> Place:
    return Place("cpu", 0)


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return (CPUPlace() if device.type == "cpu"
                else CUDAPlace(device.index or 0))
    if not isinstance(device, str):
        raise TypeError(f"device must be a str or Place, got {type(device)}")
    kind, _, ordinal = device.partition(":")
    kind = {"cuda": "gpu"}.get(kind, kind)
    if kind not in ("gpu", "cpu"):
        raise ValueError(f"the port runs on 'gpu' or 'cpu', got {device!r}")
    return Place(kind, int(ordinal) if ordinal else 0)


_place = CUDAPlace(0)


def set_device(device) -> Place:
    """Set the current device: ``'gpu'``, ``'gpu:N'``, ``'cpu'`` (or a
    ``Place``). A GPU raises at once when CUDA is absent."""
    global _place
    place = _parse(device)
    place.torch_device()                  # validate eagerly
    _place = place
    return place


def get_device() -> str:
    return f"{_place.device_type}:{_place.device_id}"


def current_place() -> Place:
    return _place


def current_device(place=None) -> torch.device:
    """The ``torch.device`` new tensors go to: `place` if given, else the
    current device. Raises RuntimeError on a GPU without CUDA."""
    return (_place if place is None else _parse(place)).torch_device()


def device_count(device_type: str = "gpu") -> int:
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def synchronize(device=None):
    """Block until the work issued to the card is complete (no-op on the
    CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(None if device is None
                               else current_device(device))
