"""FP8 matmuls with delayed scaling (training) and current scaling
(``paddle_tpu.amp.fp8`` counterpart).

Matmul inputs are quantized to ``float8_e4m3fn`` (activations, weights)
and ``float8_e5m2`` (gradients) with per-tensor scales that map the
tensor's absolute maximum near the format's max, products accumulate in
fp32 and are dequantized by the two inverse scales:

* **delayed scaling** (``fp8_dot``): the scale comes from a rolling amax
  history of earlier steps (three fp32 ``[H]`` histories per matmul
  callsite: x, w and the output gradient). The JAX package threads the
  histories through the step as the cotangent of a ``custom_vjp``; the
  port's ``torch.autograd.Function`` writes the updated histories beside
  the old ones (``nx``/``nw`` in the forward, ``ng`` in the backward) and
  ``Fp8Session.commit`` adopts them after the step, keeping the old ones
  on a skipped step (``train_step.py:874-880``);
* **current scaling** (``fp8_dot_current``, ``fp8_matmul``): scales from
  the live tensors, no state (``fp8_autocast``, the fused-CE head).

The quantization is the JAX package's ``_quant`` (``fp8.py:124-127``):
scale, clamp to the format's finite max, then cast, so the codes are
bit-equal to JAX's on either device (the cast never sees a value past the
max). The product runs ``torch._scaled_mm`` on CUDA tensors (the JAX
package's fp8 product is an XLA dot outside any Pallas kernel): fp32 out,
``use_fast_accum=False``, ``scale_a``/``scale_b`` the dequant scales 1/s,
operand b column-major, every dim padded with zero codes to a multiple of
16 (zeros change no sum). CPU tensors take the plain version: the codes
widened to fp32, an fp32 product, times ``(1/sa) * (1/sb)`` as JAX
computes it. ``LAUNCHES["scaled_mm"]`` counts the CUDA products.

The thread-local ``Fp8Session`` is the seam: ``F.linear`` asks it
(``linear_fp8_enabled``) and takes one callsite state per call, in call
order (``next_state``); a first step in ``record`` mode creates them (the
JAX package's discovery trace); a remat region's recompute rewinds the
cursor so it meets the same states. ``head_scope`` marks the LM head:
under ``matmuls`` it stays unquantized, ``matmuls+head`` quantizes it.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = [
    "FP8_POLICIES", "E4M3_MAX", "E5M2_MAX", "normalize_fp8_policy",
    "new_callsite_state", "delayed_scale", "update_history", "quantize",
    "current_scale", "mm_codes", "fp8_dot", "fp8_dot_current", "fp8_matmul",
    "fp8_autocast", "fp8_execution", "head_scope", "current_session",
    "linear_fp8_enabled", "head_fp8_enabled", "fp8_linear", "Fp8Session",
    "LAUNCHES", "reset_launches",
]

FP8_POLICIES = ("none", "matmuls", "matmuls+head")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
STATE_KEYS = ("x", "w", "g")

# torch._scaled_mm calls on CUDA tensors (the product's route; no kernel of
# the port's own: the JAX package computes it as an XLA dot)
LAUNCHES = {"scaled_mm": 0}


def reset_launches() -> None:
    LAUNCHES["scaled_mm"] = 0


def normalize_fp8_policy(policy) -> str:
    """The policy knob onto the namespace (None/False -> 'none', True ->
    'matmuls')."""
    if policy is None or policy is False:
        return "none"
    if policy is True:
        return "matmuls"
    p = str(policy)
    if p not in FP8_POLICIES:
        raise ValueError(f"unknown fp8 policy {p!r}; expected one of "
                         f"{'|'.join(FP8_POLICIES)}")
    return p


def new_callsite_state(hist_len: int = 16, device=None) -> dict:
    """Zero x / w / g amax histories, fp32 ``[hist_len]`` (scale 1.0 until
    the first observation)."""
    return {k: torch.zeros(int(hist_len), dtype=torch.float32, device=device)
            for k in STATE_KEYS}


def delayed_scale(hist, fmax: float):
    """``fmax / max(history)``, 1.0 while the history is all zeros; a
    non-finite entry counts as empty (``fmax/inf = 0`` would make the
    dequant ``0 * inf = NaN``)."""
    amax = hist.max()
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    return torch.where(amax > 0.0, _div(fmax, torch.clamp_min(amax, 1e-12)),
                       1.0).to(torch.float32)


def _div(num: float, den):
    """``num / den`` as an IEEE division (torch computes a Python scalar
    over a tensor as ``reciprocal(den) * num``, which rounds differently
    from JAX's division)."""
    return torch.full_like(den, num) / den


def update_history(hist, amax):
    """The history rolled by one with the new amax at index 0; a
    non-finite amax is replaced by the history's max."""
    amax = amax.to(torch.float32)
    amax = torch.where(torch.isfinite(amax), amax, hist.max())
    out = torch.roll(hist, 1)
    out[0] = amax
    return out


def _amax(v):
    return v.float().abs().amax()


def current_scale(v, fmax: float):
    return delayed_scale(_amax(v)[None], fmax)


def quantize(v, scale, fmax: float, dt):
    """Scale, clamp to the format's finite max, cast (``_quant``)."""
    return torch.clamp(v.float() * scale, -fmax, fmax).to(dt)


def _pad16(q, rows: int, cols: int):
    r, c = q.shape
    if (r, c) == (rows, cols):
        return q.contiguous()
    out = torch.zeros((rows, cols), dtype=q.dtype, device=q.device)
    out[:r, :c] = q
    return out


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def mm_codes(qa, sa, qb_t, sb):
    """fp32 ``(qa · qb_tᵀ) / sa / sb`` of fp8 codes qa [M, K] and qb_t
    [N, K] (b given by its rows of bᵀ) quantized with the 0-d fp32 scales
    `sa` and `sb`. CUDA tensors run ``torch._scaled_mm`` with the dequant
    scales 1/sa and 1/sb (b = qb_tᵀ, column-major; every dim padded with
    zero codes to a multiple of 16); CPU tensors the plain fp32 product of
    the widened codes times ``(1/sa) * (1/sb)``, as JAX computes it."""
    m, k = qa.shape
    n = qb_t.shape[0]
    sa_inv, sb_inv = _div(1.0, sa), _div(1.0, sb)
    if not qa.is_cuda:
        return (qa.float() @ qb_t.float().T) * (sa_inv * sb_inv)
    mp, kp, np_ = _up16(m), _up16(k), _up16(n)
    a = _pad16(qa, mp, kp)
    b = _pad16(qb_t, np_, kp).t()
    out = torch._scaled_mm(a, b, scale_a=sa_inv.reshape(()).float(),
                           scale_b=sb_inv.reshape(()).float(),
                           out_dtype=torch.float32, use_fast_accum=False)
    if isinstance(out, tuple):          # older builds return (out, amax)
        out = out[0]
    LAUNCHES["scaled_mm"] += 1
    return out[:m, :n]


def fp8_matmul(a, b, a_dtype=None, b_dtype=None):
    """Current-scaled fp8 ``a @ b`` (a [M, K], b [K, N]), fp32 out, no
    autograd of its own: the building block the fused-CE head calls in its
    forward and backward. Dtypes default to e4m3."""
    a_dtype = a_dtype or E4M3
    b_dtype = b_dtype or E4M3
    a_max = E5M2_MAX if a_dtype == E5M2 else E4M3_MAX
    b_max = E5M2_MAX if b_dtype == E5M2 else E4M3_MAX
    sa, sb = current_scale(a, a_max), current_scale(b, b_max)
    qa = quantize(a, sa, a_max, a_dtype)
    qb_t = quantize(b.t(), sb, b_max, b_dtype)
    return mm_codes(qa, sa, qb_t, sb)


class _Fp8Dot(torch.autograd.Function):
    """y = x·wᵀ for x [..., K], w [N, K] (the port's linear layout) through
    e4m3 codes, dx and dw through an e5m2 gradient. With a callsite state
    the scales are delayed (the histories) and the updated histories are
    written beside the old ones; without one they are current."""

    @staticmethod
    def forward(ctx, x, w, st):
        x2 = x.reshape(-1, x.shape[-1])
        if st is None:
            sx, sw = current_scale(x, E4M3_MAX), current_scale(w, E4M3_MAX)
        else:
            sx = delayed_scale(st["x"], E4M3_MAX)
            sw = delayed_scale(st["w"], E4M3_MAX)
            st["nx"] = update_history(st["x"], _amax(x))
            st["nw"] = update_history(st["w"], _amax(w))
        qx = quantize(x2, sx, E4M3_MAX, E4M3)
        qw = quantize(w, sw, E4M3_MAX, E4M3)
        out = mm_codes(qx, sx, qw, sw).to(x.dtype)
        ctx.save_for_backward(qx, qw, sx, sw)
        ctx.st, ctx.x_meta, ctx.w_dtype = st, (x.shape, x.dtype), w.dtype
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        qx, qw, sx, sw = ctx.saved_tensors
        st = ctx.st
        g2 = g.reshape(-1, g.shape[-1])
        sg = (current_scale(g, E5M2_MAX) if st is None
              else delayed_scale(st["g"], E5M2_MAX))
        qg = quantize(g2, sg, E5M2_MAX, E5M2)
        x_shape, x_dtype = ctx.x_meta
        # dx = g · w: b = w [N, K] by its rows of bᵀ = wᵀ [K, N]
        dx = mm_codes(qg, sg, qw.t().contiguous(), sw)
        # dw = gᵀ · x: a = gᵀ [N, M], b = x [M, K] by the rows of xᵀ
        dw = mm_codes(qg.t().contiguous(), sg, qx.t().contiguous(), sx)
        if st is not None:
            st["ng"] = update_history(st["g"], _amax(g))
        return (dx.to(x_dtype).reshape(x_shape), dw.to(ctx.w_dtype), None)


def fp8_dot(x, w, st):
    """``x · wᵀ`` through e4m3 with delayed scaling from callsite state
    `st` ({x, w, g} histories); the backward's e5m2 gradient products give
    dx and dw, and the updated histories land in st["nx"/"nw"/"ng"]."""
    return _Fp8Dot.apply(x, w, st)


def fp8_dot_current(x, w):
    """``x · wᵀ`` through e4m3 with scales from the live tensors (gradients
    through e5m2); no state."""
    return _Fp8Dot.apply(x, w, None)


class Fp8Session:
    """One fp8-enabled step: the policy and the per-callsite states.

    modes: ``record`` (the first step: ``next_state`` creates zero states
    in call order), ``execute`` (hands the states out in the same order;
    a callsite past them is a divergence), ``stateless`` (current
    scaling)."""

    def __init__(self, policy: str, mode: str, hist_len: int = 16,
                 states=None):
        self.policy = policy
        self.mode = mode
        self.hist_len = int(hist_len)
        self.states = list(states) if states is not None else []
        self.cursor = 0
        self.in_head = False

    def next_state(self, device=None):
        if self.mode == "stateless":
            return None
        if self.cursor < len(self.states):
            st = self.states[self.cursor]
        elif self.mode == "record":
            st = new_callsite_state(self.hist_len, device)
            self.states.append(st)
        else:
            raise RuntimeError(
                f"fp8: matmul callsite {self.cursor} is past the "
                f"{len(self.states)} the first step discovered: the step "
                f"diverged from the discovery step")
        self.cursor += 1
        return st

    @contextmanager
    def rewind(self, pos: int):
        """Hand the states out again from `pos` (a remat recompute), then
        put the cursor back."""
        saved = self.cursor
        self.cursor = pos
        try:
            yield
        finally:
            self.cursor = saved

    @torch.no_grad()
    def commit(self, skip=None):
        """Adopt every callsite's updated histories; where `skip` (a bool
        tensor: the step was skipped) keep the old ones."""
        for st in self.states:
            for k in STATE_KEYS:
                new = st.pop("n" + k, None)
                if new is None:
                    continue
                st[k] = new if skip is None else torch.where(skip, st[k],
                                                             new)

    def amax_max(self):
        """The largest value of every history (the step's fp8 watermark)."""
        if not self.states:
            return torch.zeros(())
        return torch.stack([st[k].max() for st in self.states
                            for k in STATE_KEYS]).max()


class _TLS(threading.local):
    def __init__(self):
        self.sess = None


_tls = _TLS()


def current_session() -> Fp8Session | None:
    return _tls.sess


@contextmanager
def installed(sess):
    """`sess` as this thread's session inside the block (None: none)."""
    prev = _tls.sess
    _tls.sess = sess
    try:
        yield sess
    finally:
        _tls.sess = prev


@contextmanager
def fp8_execution(policy, states=None, hist_len: int = 16,
                  record: bool = False):
    """Turn fp8 on for the ops run inside: delayed scaling over `states`
    (``record``: discover them), else stateless current scaling."""
    policy = normalize_fp8_policy(policy)
    if policy == "none":
        yield None
        return
    mode = ("record" if record else
            "execute" if states is not None else "stateless")
    with installed(Fp8Session(policy, mode, hist_len, states)) as s:
        yield s


def fp8_autocast(policy="matmuls"):
    """Eager fp8 with current scaling for ``F.linear`` (and, with
    'matmuls+head', the fused-CE head)."""
    return fp8_execution(policy)


@contextmanager
def head_scope():
    """Mark the LM-head region: under 'matmuls' the head stays
    unquantized; 'matmuls+head' quantizes it too."""
    s = _tls.sess
    if s is None:
        yield
        return
    prev = s.in_head
    s.in_head = True
    try:
        yield
    finally:
        s.in_head = prev


def linear_fp8_enabled(x, w) -> bool:
    """Should this ``F.linear`` call run through fp8?"""
    s = _tls.sess
    if s is None:
        return False
    if s.in_head and s.policy != "matmuls+head":
        return False
    return (w.dim() == 2 and x.dim() >= 2 and x.dtype.is_floating_point
            and w.dtype.is_floating_point)


def head_fp8_enabled() -> bool:
    """Should the fused-CE head projection quantize? (its softmax
    statistics stay fp32)"""
    s = _tls.sess
    return s is not None and s.policy == "matmuls+head"


def fp8_linear(x, w, bias=None):
    """The ``F.linear`` fp8 path (w [out, in]): this callsite's state from
    the session (None: current scaling)."""
    st = _tls.sess.next_state(x.device)
    out = fp8_dot_current(x, w) if st is None else fp8_dot(x, w, st)
    return out + bias if bias is not None else out
