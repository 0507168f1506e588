"""Quantization helpers of the port (``paddle_tpu.quantization``
counterpart, only what the serving KV page pools need).

``absmax_scale`` is the absmax -> scale rule the JAX package shares between
its observers and the serving KV pools,
``AbsmaxChannelWiseObserver.kv_page_scales`` the per-slot-per-head scales the
model's decode path quantizes K/V with, and ``quantize_kv`` that
quantize-on-write itself (codes for int8 or fp8-e4m3 pages plus their
scales).
"""
from __future__ import annotations

import torch

__all__ = ["absmax_scale", "AbsmaxChannelWiseObserver", "quantize_kv",
           "raw_bytes"]

# largest code magnitude of each KV code dtype
_CODE_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def raw_bytes(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as a uint8 view of its bits (any other tensor as
    itself): PyTorch leaves some index ops (``index_copy_``, ``index_put_``)
    unimplemented for float8, and a code is moved bit for bit anyway."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def absmax_scale(absmax, quant_bits: int = 8, qmax: float | None = None):
    """``max(absmax / qmax, 1e-8)`` in fp32, with qmax ``2^(bits-1) - 1`` by
    default (127 for int8) or given (448 for fp8 e4m3)."""
    if qmax is None:
        qmax = 2 ** (quant_bits - 1) - 1
    return (torch.as_tensor(absmax).to(torch.float32) / qmax).clamp_min(1e-8)


class AbsmaxChannelWiseObserver:
    """Per-channel absmax observer; only the KV-page scale rule is ported."""

    @classmethod
    def kv_page_scales(cls, values, quant_bits: int = 8,
                       qmax: float | None = None):
        """Per-slot-per-head scales of a ``[..., head_dim]`` K or V
        activation about to be written into quantized pages: the absmax over
        head_dim (taken in the activation's dtype), then ``absmax_scale``.
        Returns fp32 ``[...]``."""
        return absmax_scale(values.abs().amax(dim=-1), quant_bits, qmax=qmax)


def quantize_kv(values, code_dtype):
    """Quantize-on-write of a ``[..., head_dim]`` K or V activation into
    ``code_dtype`` codes (``torch.int8`` or ``torch.float8_e4m3fn``):
    per-slot-per-head scales from ``kv_page_scales``, the division in fp32,
    then round and clip to +-127 (int8) or a cast (e4m3, where x / scale
    at most a rounding step above 448 rounds to 448). Returns (codes, fp32
    scales ``[...]``), as the JAX model computes them."""
    scales = AbsmaxChannelWiseObserver.kv_page_scales(
        values, qmax=_CODE_QMAX[code_dtype])
    x = values.float() / scales[..., None]
    if code_dtype == torch.int8:
        x = x.round().clamp(-127, 127)
    return x.to(code_dtype), scales
