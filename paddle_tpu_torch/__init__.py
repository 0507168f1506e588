"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module tree and names, imports ``torch`` and numpy only (never ``jax`` and
nothing of ``paddle_tpu``), and replaces each TPU Pallas kernel on its path
with a hand-written CUDA kernel for ``sm_90a`` (``ops/cuda``). It serves
LLaMA (``models.llama`` + ``serving.ServingEngine``) and trains it
(``models.llama`` with labels + ``optimizer.AdamW`` +
``parallel.TrainStep``, fed by ``io.pack_examples``).

Entry points default to ``device="cuda"`` and raise when CUDA is absent;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
from paddle_tpu_torch.core.device import resolve_device

__all__ = ["resolve_device"]
