"""The port's hand-written Hopper kernels (CUDA C++ under ``csrc/``, built
with nvcc on first use and bound with ctypes), each beside its plain
PyTorch version and a launch counter."""
from paddle_tpu_torch.ops.cuda import flash_attention, paged_attention

__all__ = ["flash_attention", "paged_attention", "reset_launch_counts",
           "launch_counts"]

_KERNELS = {"flash_fwd": flash_attention, "paged_decode": paged_attention}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.reset_launches()


def launch_counts() -> dict[str, int]:
    return {name: mod.launches() for name, mod in _KERNELS.items()}
