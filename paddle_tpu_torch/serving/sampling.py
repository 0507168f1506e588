"""Batched token sampling for the serving decode step
(``paddle_tpu.serving.sampling`` counterpart).

Greedy, temperature, top-k and top-p are driven by PER-ROW parameter
tensors, so mixing sampling configs in one batch takes one code path.
Every request owns a ``torch.Generator`` seeded from (sample_seed, submit
order); each step draws one uniform number per row on the host from the
row's generator (greedy rows draw too, so a temperature switch mid-stream
does not correlate a request with its own history) and samples by inverse
CDF on the logits' device. Replaying a request with the same seed gives
the same tokens on CPU and CUDA alike. JAX's threefry bits cannot be
reproduced, so sampled streams are not comparable across packages; greedy
streams are.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_tokens", "request_generator"]

_NEG_INF = -1e30


def request_generator(seed: int, order: int) -> torch.Generator:
    """Per-request CPU generator: stream identity is (seed, submit order)."""
    state = np.random.SeedSequence([int(seed), int(order)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator()
    gen.manual_seed(int(state) & ((1 << 63) - 1))
    return gen


def _mask_top_k(logits, top_k):
    """Per-row top-k: k <= 0 disables; ties at the k-th value survive."""
    v = logits.shape[-1]
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, v),
                        top_k.clamp(1, v))
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, (k_eff - 1).long()[:, None])
    return logits.masked_fill(logits < kth, _NEG_INF)


def _mask_top_p(logits, top_p):
    """Per-row nucleus: keep the smallest prefix of the sorted distribution
    whose mass reaches p (the first exceeding token included); p >= 1
    disables, p <= 0 degenerates to top-1."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < top_p[:, None]
    keep[:, 0] = True                                 # always keep the argmax
    thresh = torch.where(keep, sorted_desc,
                         torch.full_like(sorted_desc, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, _NEG_INF)


def sample_tokens(logits, generators, temperature, top_k, top_p):
    """One sampling step over the packed decode batch.

    logits: [B, V]; generators: B ``torch.Generator``s (None for empty
    slots); temperature/top_k/top_p: [B] tensors on the logits' device
    (temperature <= 0 -> greedy argmax, top_k <= 0 and top_p >= 1 off).
    Returns tokens [B] int32 on the logits' device."""
    logits = logits.float()
    greedy = temperature <= 0.0
    u = torch.tensor([float(torch.rand((), generator=g)) if g is not None
                      else 0.0 for g in generators],
                     dtype=torch.float32).to(logits.device)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    masked = _mask_top_p(_mask_top_k(scaled, top_k), top_p)
    cdf = torch.cumsum(torch.softmax(masked, dim=-1), dim=-1)
    sampled = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None],
                               right=True).squeeze(1)
    sampled = sampled.clamp_max(logits.shape[-1] - 1)
    tokens = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
    return tokens.to(torch.int32)
