"""Operators of the port (``paddle_tpu.ops`` counterpart). ``rmsnorm`` is
the fused RMSNorm kernel's public entry (``paddle_tpu.ops.pallas.rmsnorm``
in the JAX package)."""
from paddle_tpu_torch.ops.cuda.rmsnorm_kernel import rmsnorm

__all__ = ["rmsnorm"]
