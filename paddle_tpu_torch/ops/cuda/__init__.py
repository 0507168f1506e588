"""The port's hand-written Hopper kernels (CUDA C++ under ``csrc/``, built
with nvcc on first use and bound with ctypes), each beside its plain
PyTorch version and a launch counter."""
from paddle_tpu_torch.ops.cuda import (flash_attention, fused_ce,
                                       grouped_matmul, paged_attention,
                                       rmsnorm_kernel)

__all__ = ["flash_attention", "fused_ce", "grouped_matmul",
           "paged_attention", "rmsnorm_kernel", "reset_launch_counts",
           "launch_counts"]

_MODULES = (flash_attention, paged_attention, fused_ce, grouped_matmul,
            rmsnorm_kernel)


def reset_launch_counts() -> None:
    for mod in _MODULES:
        mod.reset_launches()


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}: flash_fwd,
    flash_bwd_dq, flash_bwd_dkv, flash_visit, paged_decode,
    paged_decode_int8, paged_decode_fp8, paged_visit, ce_stats, ce_bwd,
    gmm_fwd, gmm_fwd_tf32, gmm_dw, gmm_visit, rmsnorm_fwd, rmsnorm_bwd,
    rmsnorm_dw. ce_bwd counts the fused-CE backward's C entry, one a bf16
    backward call (its kernels for every token chunk)."""
    counts = {}
    for mod in _MODULES:
        counts.update(mod.launch_counts())
    return counts
