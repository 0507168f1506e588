"""The port's hand-written Hopper kernels (CUDA C++ under ``csrc/``, built
with nvcc on first use and bound with ctypes), each beside its plain
PyTorch version and a launch counter."""
from paddle_tpu_torch.ops.cuda import (flash_attention, fused_ce,
                                       grouped_matmul, paged_attention)

__all__ = ["flash_attention", "fused_ce", "grouped_matmul",
           "paged_attention", "reset_launch_counts", "launch_counts"]

_MODULES = (flash_attention, paged_attention, fused_ce, grouped_matmul)


def reset_launch_counts() -> None:
    for mod in _MODULES:
        mod.reset_launches()


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}: flash_fwd,
    flash_bwd_dq, flash_bwd_dkv, paged_decode, ce_stats, gmm_fwd, gmm_dw,
    gmm_visit."""
    counts = {}
    for mod in _MODULES:
        counts.update(mod.launch_counts())
    return counts
