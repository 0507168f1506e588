"""Mixture-of-Experts layer, local mode (``paddle_tpu.incubate.distributed.
models.moe.moe_layer`` counterpart).

Two dispatch modes, as in the JAX package:

* ``dispatch="capacity"`` (the ``moe_dispatch`` flag's default): tokens are
  scatter-added into fixed [E, C, d] capacity buckets, the batched expert
  FFNs run as two einsums, overflow tokens are dropped and counted;
* ``dispatch="dropless"``: the sort-based ragged dispatch of
  ``dropless.py`` over the hand-written grouped-matmul kernels, token- or
  expert-choice routing, optional dense shared expert.

Parameters keep the JAX layout: ``gate.gate_weight`` [d, E], experts
``w1`` [E, d, h], ``w2`` [E, h, d], ``b1`` [E, 1, h], ``b2`` [E, 1, d],
shared-expert weights [in, out]. Random routing (GShard's second-expert
drop, Switch's jitter) draws from a ``torch.Generator`` the layer holds,
seeded by ``seed`` (``manual_seed``), never from a global RNG; the JAX
package's threefry streams cannot be reproduced, so cross-package parity
runs with deterministic gates. Expert parallelism (ep > 1) raises
``NotImplementedError`` (ROADMAP A9); the observability registry waits for
ROADMAP A10.

After each forward the layer keeps ``l_aux``, ``tokens_dropped`` and
``expert_counts`` as device tensors (and, on the dropless path,
``last_layout``: the bucket gids and block rows the grouped matmul ran
over); ``last_stats`` reads them, the only host sync.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.incubate.distributed.models.moe.dropless import (
    EP_NOT_PORTED, _act, _dropless_moe, _expert_choice_moe, _gshard_aux,
    _reduce_stats)
from paddle_tpu_torch.nn import functional as F

__all__ = ["MoELayer", "ExpertFFN", "NaiveGate", "GShardGate", "SwitchGate"]


def _xavier(shape, device, dtype, seed):
    """Xavier-normal draw over the trailing [fan_in, fan_out] matrix of
    each leading index, from its own seeded generator."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(int(seed))
    std = math.sqrt(2.0 / (shape[-2] + shape[-1]))
    p = torch.empty(shape, device=device, dtype=torch.float32)
    return nn.Parameter(p.normal_(0.0, std, generator=gen).to(dtype or
                                                             torch.float32))


def _zeros(shape, device, dtype):
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))


class NaiveGate(nn.Module):
    """Top-k softmax gate: ``forward`` gives the logits ``x @ gate_weight``;
    the routing itself is ``_route``, described by ``routing_config``."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 device=None, dtype=None, seed=0):
        super().__init__()
        self.num_expert = num_expert
        self.topk = topk
        self.gate_weight = _xavier((d_model, num_expert), device, dtype, seed)

    def forward(self, x):
        return x @ self.gate_weight

    def routing_config(self, training: bool) -> tuple:
        return (("kind", "naive"),)

    def cap_rate(self, training: bool):
        """Gate-level per-expert capacity as a fraction of the tokens, or
        None."""
        return None


class GShardGate(NaiveGate):
    """Top-2 with random second-expert routing (kept with probability
    min(1, 2 p2) while training) and gate-level capacity."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None,
                 device=None, dtype=None, seed=0):
        if topk != 2:
            raise ValueError("topk should be 2 in gshard")
        super().__init__(d_model, num_expert, world_size, topk, device,
                         dtype, seed)
        self.capacity = tuple(capacity)
        self.random_routing = random_routing

    def routing_config(self, training: bool) -> tuple:
        return (("kind", "gshard"),
                ("random_routing", bool(self.random_routing and training)))

    def cap_rate(self, training: bool):
        return float(self.capacity[0 if training else 1])


class SwitchGate(NaiveGate):
    """Switch top-1 gate: train-time uniform jitter in [1-eps, 1+eps] added
    to the logits, gate-level capacity."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None,
                 device=None, dtype=None, seed=0):
        if topk != 1:
            raise ValueError("topk should be 1 in switch")
        super().__init__(d_model, num_expert, world_size, 1, device, dtype,
                         seed)
        self.switch_eps = float(switch_eps)
        self.capacity = tuple(capacity)

    def routing_config(self, training: bool) -> tuple:
        return (("kind", "switch"),
                ("switch_eps", self.switch_eps if training else 0.0))

    def cap_rate(self, training: bool):
        return float(self.capacity[0 if training else 1])


class ExpertFFN(nn.Module):
    """Batched expert MLPs: ``w1`` [E, d, h], ``w2`` [E, h, d], ``b1``
    [E, 1, h], ``b2`` [E, 1, d]."""

    def __init__(self, num_expert, d_model, d_hidden, activation="gelu",
                 device=None, dtype=None, seed=0):
        super().__init__()
        self.num_expert = num_expert
        self.w1 = _xavier((num_expert, d_model, d_hidden), device, dtype, seed)
        self.w2 = _xavier((num_expert, d_hidden, d_model), device, dtype,
                          seed + 1)
        self.b1 = _zeros((num_expert, 1, d_hidden), device, dtype)
        self.b2 = _zeros((num_expert, 1, d_model), device, dtype)
        self.act = activation

    def forward(self, x):
        """x: [E, C, d] -> [E, C, d]."""
        h = _act(torch.einsum("ecd,edh->ech", x, self.w1) + self.b1,
                 self.act)
        return torch.einsum("ech,ehd->ecd", h, self.w2) + self.b2


def _route(logits, generator, *, k, routing):
    """Gate routing: fp32 logits [N, E] -> (topv [N, k] renormalised,
    topi [N, k] with dropped selections at -1, probs [N, E]). The Switch
    jitter and GShard's random routing draw from `generator`."""
    cfg = dict(routing or ())
    kind = cfg.get("kind", "naive")
    if kind == "switch" and cfg.get("switch_eps", 0.0) > 0.0:
        eps = cfg["switch_eps"]
        noise = torch.rand(logits.shape, generator=generator,
                           device=logits.device)
        logits = logits + (noise * 2.0 * eps + 1.0 - eps)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    raw_topv = topv                  # pre-renormalisation softmax probs
    topv = topv / topv.sum(-1, keepdim=True)
    if kind == "gshard" and cfg.get("random_routing", False):
        # keep the second expert with probability min(1, 2 p2), applied
        # before any capacity bucketing (the JAX package's order)
        pr = torch.rand((logits.shape[0],), generator=generator,
                        device=logits.device)
        drop2 = 2.0 * raw_topv[:, 1] < pr
        topi = torch.cat([topi[:, :1],
                          torch.where(drop2, -1, topi[:, 1])[:, None],
                          topi[:, 2:]], dim=1)
    return topv, topi, probs


def _sparse_moe(xv, gv, generator, w1, b1, w2, b2, *, E, k, cf, act, ep=1,
                routing=(), cap_rate=None):
    """Capacity-bucketed dispatch and combine: xv [N, d], gv [N, E] gate
    logits. Returns (out [N, d], l_aux, dropped, counts [E])."""
    if ep > 1:
        raise NotImplementedError(EP_NOT_PORTED)
    n, d = xv.shape
    c = max(1, int(math.ceil(cf * k * n / E)))
    topv, topi, probs = _route(gv.float(), generator, k=k, routing=routing)

    flat_e = topi.reshape(-1)                                    # [N*k]
    chosen = flat_e >= 0                                         # routing drop
    oh = (flat_e[:, None] == torch.arange(E, device=xv.device)).long()
    pos = (torch.cumsum(oh, 0) * oh).sum(-1) - 1                 # [N*k]
    limit = c
    if cap_rate is not None:
        limit = min(c, max(1, int(math.ceil(cap_rate * n))))
    valid = chosen & (pos >= 0) & (pos < limit)
    dropped = (chosen & ~valid).float().sum()
    safe_e = flat_e.clamp(0, E - 1)
    counts = torch.zeros(E, device=xv.device).index_add(0, safe_e,
                                                        valid.float())
    dest = safe_e * c + pos.clamp(0, c - 1)                      # [N*k]

    xp = xv.repeat_interleave(k, dim=0)                          # [N*k, d]
    buf = xv.new_zeros((E * c, d)).index_add(
        0, dest, xp * valid[:, None].to(xv.dtype))
    h = _act(torch.einsum("ecd,edh->ech", buf.reshape(E, c, d), w1) + b1, act)
    ybuf = (torch.einsum("ech,ehd->ecd", h, w2) + b2).reshape(E * c, d)

    wgt = (topv.reshape(-1) * valid.float()).to(xv.dtype)
    out = (ybuf[dest] * wgt[:, None]).reshape(n, k, d).sum(1)
    l_aux, dropped, counts = _reduce_stats(_gshard_aux(probs, topi, E),
                                           dropped, counts)
    return out, l_aux.to(xv.dtype), dropped, counts


def _group_size(group) -> int:
    if group is None:
        return 1
    return int(getattr(group, "nranks", getattr(group, "world_size", 1)))


class MoELayer(nn.Module):
    """``MoELayer(d_model, num_expert=, d_hidden=, top_k=2, dispatch=None,
    router="token", shared_expert_hidden=0, device=, dtype=, seed=0)``.

    ``gate`` is 'gshard' (default), 'naive', 'switch' or a gate module;
    ``experts`` an ``ExpertFFN`` (a list of per-expert MLPs is not ported).
    ``dispatch=None`` reads the ``moe_dispatch`` flag. ``seed`` seeds the
    weights' draw and the routing generator. A ``moe_group`` of more than
    one rank (expert parallelism) raises ``NotImplementedError``."""

    def __init__(self, d_model, experts=None, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, num_expert=None,
                 d_hidden=None, top_k=2, capacity_factor=1.25, dispatch=None,
                 router="token", shared_expert_hidden=0, device=None,
                 dtype=None, seed=0, **kwargs):
        super().__init__()
        if _group_size(moe_group) > 1:
            raise NotImplementedError(EP_NOT_PORTED)
        self.d_model = d_model
        self.dispatch = dispatch or flag("moe_dispatch")
        if self.dispatch not in ("capacity", "dropless"):
            raise ValueError(
                f"dispatch={self.dispatch!r}: 'capacity' or 'dropless'")
        if router not in ("token", "expert"):
            raise ValueError(f"router={router!r}: 'token' or 'expert'")
        if router == "expert" and self.dispatch != "dropless":
            raise ValueError("expert-choice routing requires the dropless "
                             "dispatch (it has no capacity buckets)")
        self.router = router
        if isinstance(experts, ExpertFFN):
            self.experts = experts
            num_expert = experts.num_expert
        elif experts is not None:
            raise NotImplementedError(
                "a list of per-expert MLPs is not ported; pass an ExpertFFN "
                "or num_expert and d_hidden")
        else:
            if num_expert is None or d_hidden is None:
                raise ValueError("MoELayer needs experts, or num_expert and "
                                 "d_hidden")
            self.experts = ExpertFFN(num_expert, d_model, d_hidden,
                                     device=device, dtype=dtype,
                                     seed=seed + 1)
        self.num_expert = num_expert
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        if gate is None or gate == "gshard":
            self.gate = GShardGate(d_model, num_expert, topk=top_k,
                                   device=device, dtype=dtype, seed=seed)
        elif gate == "naive":
            self.gate = NaiveGate(d_model, num_expert, topk=top_k,
                                  device=device, dtype=dtype, seed=seed)
        elif gate == "switch":
            self.gate = SwitchGate(d_model, num_expert, device=device,
                                   dtype=dtype, seed=seed)
            self.top_k = 1
        else:
            self.gate = gate
        self.shared_expert_hidden = int(shared_expert_hidden)
        if self.shared_expert_hidden:
            hs = self.shared_expert_hidden
            self.shared_w1 = _xavier((d_model, hs), device, dtype, seed + 3)
            self.shared_b1 = _zeros((hs,), device, dtype)
            self.shared_w2 = _xavier((hs, d_model), device, dtype, seed + 4)
            self.shared_b2 = _zeros((d_model,), device, dtype)
        self.l_aux = None
        self.tokens_dropped = None
        self.expert_counts = None
        self.last_layout = None
        self._routing_seed = int(seed)
        self._generator = None

    def manual_seed(self, seed: int) -> None:
        """Reseed the routing generator (random routing restarts)."""
        self._routing_seed = int(seed)
        self._generator = None

    def routing_generator(self, device) -> torch.Generator:
        """The layer's routing generator on `device`, made on first use."""
        device = torch.device(device)
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
            self._generator.manual_seed(self._routing_seed)
        return self._generator

    def _gate_semantics(self):
        """(routing, cap_rate) from the gate, honouring train/eval mode."""
        routing, cap_rate = (), None
        if hasattr(self.gate, "routing_config"):
            routing = tuple(self.gate.routing_config(self.training))
        if hasattr(self.gate, "cap_rate"):
            cap_rate = self.gate.cap_rate(self.training)
        return routing, cap_rate

    def _shared_vals(self):
        if not self.shared_expert_hidden:
            return ()
        return (self.shared_w1, self.shared_b1, self.shared_w2,
                self.shared_b2)

    def forward(self, x):
        """x: [B, S, d] (or [N, d])."""
        orig_shape = x.shape
        x2 = x.reshape(-1, orig_shape[-1])
        E, k = self.num_expert, self.top_k
        logits = self.gate(x2)                                   # [N, E]
        routing, cap_rate = self._gate_semantics()
        cfg = dict(routing)
        # the generator is touched only when the gate randomises, so
        # deterministic gates never consume its stream
        gen = (self.routing_generator(x.device)
               if cfg.get("random_routing") or cfg.get("switch_eps") else None)
        ex = self.experts
        args = (x2, logits, gen, ex.w1, ex.b1, ex.w2, ex.b2)
        if self.dispatch == "dropless":
            body = (_expert_choice_moe if self.router == "expert"
                    else _dropless_moe)
            out, l_aux, dropped, counts, self.last_layout = body(
                *args, *self._shared_vals(), E=E, k=k, act=ex.act,
                routing=routing)
        else:
            out, l_aux, dropped, counts = _sparse_moe(
                *args, E=E, k=k, cf=self.capacity_factor, act=ex.act,
                routing=routing, cap_rate=cap_rate)
            if self.shared_expert_hidden:
                # the dense shared branch rides outside the capacity body,
                # with paddle's F.gelu (the erf form)
                h = x2 @ self.shared_w1 + self.shared_b1
                h = F.gelu(h) if ex.act == "gelu" else F.relu(h)
                out = out + (h @ self.shared_w2 + self.shared_b2)
        self.l_aux = l_aux
        self.tokens_dropped = dropped
        self.expert_counts = counts
        return out.reshape(orig_shape)

    @property
    def last_stats(self):
        """{aux_loss, dropped_tokens, expert_tokens,
        imbalance_max_over_mean} of the last forward (host numbers), or
        None before the first; reading it is the host sync."""
        if self.l_aux is None:
            return None
        counts = self.expert_counts.detach().double().cpu()
        mean = float(counts.mean()) or 1.0
        return {"aux_loss": float(self.l_aux.detach()),
                "dropped_tokens": float(self.tokens_dropped),
                "expert_tokens": counts.tolist(),
                "imbalance_max_over_mean": float(counts.max()) / mean}
