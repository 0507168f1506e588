"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module tree and names, imports ``torch`` and numpy only (never ``jax`` and
nothing of ``paddle_tpu``), and replaces each TPU Pallas kernel on its path
with a hand-written CUDA kernel for ``sm_90a`` (``ops/cuda``). It serves
LLaMA (``models.llama`` + ``serving.ServingEngine``) and trains it
(``models.llama`` with labels + ``optimizer.AdamW`` +
``parallel.TrainStep``, fed by ``io.pack_examples``).

It is also the Paddle eager API on torch autograd, as ``paddle_tpu`` is on
JAX: ``import paddle_tpu_torch as paddle`` gives ``Tensor``,
``to_tensor``, the op library, ``seed``, ``no_grad``, ``grad``, and
``nn``, ``optimizer``, ``autograd`` and ``amp``; models written on it
(``models.gpt``) train with ``loss.backward(); opt.step();
opt.clear_grad()``. ``save``/``load`` write and read the JAX package's
files (``framework.io_``); ``summary``/``flops`` inspect a model.

Entry points default to the card (``device="cuda"``; the Paddle API's
current device is ``"gpu"``) and raise when CUDA is absent; pass
``device="cpu"`` (or call ``set_device("cpu")``) to run the plain PyTorch
versions of the kernels. Importing the package builds and loads no
kernel: each is built at its first launch.
"""
from paddle_tpu_torch.core.device import (CPUPlace, CUDAPlace, device_count,
                                          get_device, is_compiled_with_cuda,
                                          resolve_device, set_device,
                                          synchronize)
from paddle_tpu_torch.core.dtype import (bfloat16, bool_, complex64,
                                         complex128, float16, float32,
                                         float64, get_default_dtype, int8,
                                         int16, int32, int64,
                                         set_default_dtype, uint8)
from paddle_tpu_torch.core.dtype import bool_ as bool  # noqa: A001
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.core.tensor import Tensor, is_tensor, to_tensor
from paddle_tpu_torch.autograd.tape import (enable_grad, no_grad,
                                            set_grad_enabled)
from paddle_tpu_torch.ops import *  # noqa: F401,F403
from paddle_tpu_torch.ops import seed
from paddle_tpu_torch import (amp, autograd, framework, io, metric, nn,
                              optimizer, regularizer)
from paddle_tpu_torch.framework import (LazyGuard, finfo,
                                        get_cuda_rng_state, get_rng_state,
                                        iinfo, in_dynamic_mode,
                                        is_compiled_with_cinn,
                                        is_compiled_with_custom_device,
                                        is_compiled_with_rocm,
                                        is_compiled_with_xpu,
                                        set_cuda_rng_state,
                                        set_printoptions, set_rng_state)
from paddle_tpu_torch.framework.inspection import flops, summary
from paddle_tpu_torch.framework.io_ import load, save
from paddle_tpu_torch.nn.initializer import ParamAttr
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

grad = autograd.grad
