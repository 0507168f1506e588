"""Device resolution for the port's entry points (``paddle_tpu.core.device``
counterpart).

The port's entry points take an explicit ``device`` and default to
``"cuda"``. They run on the CPU only when the caller asks for it
(``device="cpu"``, as the CPU tests do); a CUDA request on a machine
without CUDA raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE"]

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
