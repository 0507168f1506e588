"""Per-layer rematerialization policies and the ZeRO-3 layer loop
(``paddle_tpu.parallel.scan_layers`` counterpart): ``REMAT_POLICIES``,
``normalize_remat``, ``layer_execution``, ``current_layer_ctx``,
``LayerExecContext``, ``ScanShardInfo``, ``tag_residual``,
``unrolled_layer_call`` and ``zero3_layer_loop``.

A model that applies the policy per layer sets ``layer_remat_capable`` and
reads ``current_layer_ctx()`` in its layer loop, so the embedding, the
final norm and the fused head never sit in a remat region. Each policy
wraps one decoder layer:

* ``none``: the layer as it is;
* ``full`` and ``save_nothing``: ``torch.utils.checkpoint`` (non-reentrant)
  of the layer: only its input is kept, the interior is recomputed in the
  backward;
* ``save_dots``: the same checkpoint with a selective policy keeping the
  unbatched matmul outputs (``aten.mm``/``addmm``/``_scaled_mm``: the
  projections; JAX's ``dots_with_no_batch_dims_saveable``) and recomputing
  the rest;
* ``offload_residuals``: the layer's input and its residual-stream tensors
  (``tag_residual``, JAX's ``checkpoint_name(..., "residual")``) kept in
  pinned host memory (a plain host copy for a CPU tensor), everything else
  recomputed from them in the backward, with the host copies substituted
  for the recomputed residuals.

Raw kernel launches are invisible to PyTorch's dispatcher, so a recompute
reruns them (they write into buffers the recompute allocates again); the
selective policy keeps only the matmul outputs of the first run. The
recompute runs under the first run's AMP state, ``amp.fp8`` session and
packed-batch context (``parallel.segments``; autograd runs a CUDA
backward on its own thread), with the session's callsite cursor rewound,
so it meets the same casts, amax histories and segment ids.

``scan_layers=True`` (and ``layer_execution(stacked=)``) is accepted and
the same layers run unrolled: eager PyTorch has no traced program for a
scan to shrink.

ZeRO-3 (``layer_execution(shard_info=ScanShardInfo(sharder, mode))``,
JAX ``_zero3_scan``): a cooperating model runs its decoder layers through
``zero3_layer_loop``, one ``torch.autograd.Function`` a layer whose
parameters persist as this rank's shards of the layer's flat buffers
(``distributed.fleet.meta_parallel.sharding.group_sharded``). The forward
gathers a layer's full weights, runs it without a graph, keeps only its
input and frees the weights; the backward gathers them again, recomputes
the layer (the "full" grade, whatever the session's policy), runs its
backward into one flat gradient buffer, frees the weights and
reduce-scatters the gradient into the shards' gradients. At "ahead" the
next layer's all-gather (the layer below it in the backward) is in
flight while a layer computes, so at most two layers' full weights are
live; at "start" every layer is gathered before the first one runs, in
each direction, and released after its own turn. fp8 delayed scaling
raises under the loop, as in JAX.
"""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager

import torch
from torch.utils import checkpoint as _ckpt

__all__ = ["REMAT_POLICIES", "normalize_remat",
           "layer_execution", "current_layer_ctx", "LayerExecContext",
           "ScanShardInfo", "tag_residual", "unrolled_layer_call",
           "zero3_layer_loop"]

REMAT_POLICIES = ("none", "full", "save_dots", "save_nothing",
                  "offload_residuals")


def normalize_remat(remat) -> str:
    """The bool knob onto the policy namespace (True -> 'full',
    False/None -> 'none'); policy strings pass through validated."""
    if remat is None or remat is False:
        return "none"
    if remat is True:
        return "full"
    policy = str(remat)
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; expected one of "
            f"{'|'.join(REMAT_POLICIES)} (or a bool)")
    return policy


class ScanShardInfo:
    """The ZeRO-3 contract of a layer stack (JAX ``ScanShardInfo``): the
    `sharder` (a ``ParamSharder``) whose loop units are the layers, and the
    gather schedule `mode`, "ahead" or "start"."""

    __slots__ = ("sharder", "mode")

    def __init__(self, sharder, mode: str = "ahead"):
        if mode not in ("ahead", "start"):
            raise ValueError(
                f"unknown zero3 gather mode {mode!r}; expected "
                f"'ahead'|'start'")
        self.sharder = sharder
        self.mode = mode


class LayerExecContext:
    """What a step asks of a cooperating model's layer stack."""

    __slots__ = ("policy", "shard_info")

    def __init__(self, policy: str = "none", shard_info=None):
        self.policy = policy
        self.shard_info = shard_info


class _TLS(threading.local):
    def __init__(self):
        self.ctx = None
        self.residuals = None       # a layer's tagged tensors being captured
        self.substitute = None      # their saved copies, for the recompute
        self.recomputed = None      # the recompute's own values of them


_tls = _TLS()


def current_layer_ctx() -> LayerExecContext | None:
    return _tls.ctx


@contextmanager
def layer_execution(policy: str = "none", stacked=None, shard_info=None):
    """Install the layer policy (and, with `shard_info`, the ZeRO-3 loop)
    for a cooperating model's layer loop; `stacked` is accepted (the
    layers run unrolled)."""
    policy = normalize_remat(policy)
    if shard_info is not None and policy not in ("none", "full"):
        raise ValueError(
            f"the ZeRO-3 layer loop re-gathers and recomputes each layer in "
            f"backward (its own 'full'-grade schedule); remat policy "
            f"{policy!r} cannot apply to the sharded stack")
    prev = _tls.ctx
    _tls.ctx = LayerExecContext(policy, shard_info)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


def tag_residual(x):
    """Mark a residual-stream tensor (identity). Inside an
    ``offload_residuals`` layer the tensor is captured in the forward and,
    in the recompute, replaced by its saved copy."""
    if _tls.residuals is not None:
        _tls.residuals.append(x)
    elif _tls.substitute:
        _tls.recomputed.append(x)
        return _tls.substitute.pop(0)
    return x


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten._scaled_mm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _replaying(fn):
    """`fn` whose second and later runs (the recompute) run under the
    thread-local state of the first: the AMP state, the packed-batch
    context, the sep group, and the fp8 session with its callsite cursor rewound to where
    the first run started. Autograd runs a CUDA backward on its own device
    thread, where none of them is installed."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import fp8
    from paddle_tpu_torch.parallel import segments

    first = {}

    def run(*a):
        if not first:
            sess = fp8.current_session()
            first.update(amp=amp.state_snapshot(), sess=sess,
                         seg=segments.current_segment_ctx(),
                         sep=segments.current_sep_group(),
                         cursor=sess.cursor if sess is not None else 0)
            return fn(*a)
        sess = first["sess"]
        with amp.restored_state(first["amp"]), fp8.installed(sess), \
                segments.restored_segment_ctx(first["seg"]), \
                segments.sep_execution(first["sep"]):
            if sess is None:
                return fn(*a)
            with sess.rewind(first["cursor"]):
                return fn(*a)

    return run


def _to_host(t):
    if not t.is_cuda:
        return t.detach().clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t.detach(), non_blocking=True)
    return out


class _OffloadedLayer(torch.autograd.Function):
    """One layer under ``offload_residuals``: the forward runs it without a
    graph and keeps on the host its input and the tagged residuals other
    than its output (the next layer keeps that); the backward copies them
    back, recomputes the layer with the copies substituted for the
    recomputed residuals, and runs the segments' backward from the output
    down, each segment from its root to the copy it started from."""

    @staticmethod
    def forward(ctx, run, x, *params):
        _tls.residuals = []
        try:
            with torch.no_grad():
                y = run(x)
            tagged = [t for t in _tls.residuals if t is not y]
        finally:
            _tls.residuals = None
        ctx.run, ctx.params = run, params
        ctx.host = [_to_host(t) for t in [x] + tagged]
        return y

    @staticmethod
    def backward(ctx, gy):
        dev = gy.device
        leaves = [h.to(dev, non_blocking=True).requires_grad_(True)
                  for h in ctx.host]
        _tls.substitute, _tls.recomputed = list(leaves[1:]), []
        try:
            with torch.enable_grad():
                y = ctx.run(leaves[0])
            roots = _tls.recomputed + [y]
        finally:
            _tls.substitute = _tls.recomputed = None
        params = [p for p in ctx.params if p.requires_grad]
        grads = {}
        g = gy
        for root, leaf in zip(roots[::-1], leaves[::-1]):
            outs = torch.autograd.grad(root, [leaf] + params, g,
                                       allow_unused=True)
            g = outs[0]
            for p, gp in zip(params, outs[1:]):
                if gp is not None:
                    grads[id(p)] = gp + grads[id(p)] if id(p) in grads \
                        else gp
        return (None, g) + tuple(grads.get(id(p)) for p in ctx.params)


def unrolled_layer_call(layer, x, args: tuple = (), kwargs: dict | None = None,
                        policy: str = "none"):
    """``layer(x, *args, **kwargs)`` under the remat `policy`, one layer
    per region."""
    kwargs = kwargs or {}
    policy = normalize_remat(policy)
    if policy == "none":
        return layer(x, *args, **kwargs)
    run = _replaying(lambda h: layer(h, *args, **kwargs))
    if policy == "offload_residuals":
        return _OffloadedLayer.apply(run, x, *layer.parameters())
    context_fn = (functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                    _save_dots)
                  if policy == "save_dots" else _ckpt.noop_context_fn)
    return _ckpt.checkpoint(run, x, use_reentrant=False,
                            context_fn=context_fn)


# ---- ZeRO-3: the gather-ahead layer loop ------------------------------------

class _Zero3Loop:
    """One pass of a layer stack over a sharder's loop units: which unit
    to gather, prefetch and release around each layer's turn, forward
    (`step` +1) and backward (-1)."""

    def __init__(self, sharder, units, mode):
        self.sharder, self.units, self.mode = sharder, units, mode

    def enter(self, k, step):
        """Gather layer k's weights; start the gathers the mode asks for
        before layer k computes."""
        s, units = self.sharder, self.units
        if self.mode == "start" and k == (0 if step > 0 else len(units) - 1):
            for u in (units if step > 0 else units[::-1]):
                s.prefetch(u)
        s.gather(units[k])
        if self.mode == "ahead" and 0 <= k + step < len(units):
            s.prefetch(units[k + step])

    def leave(self, k):
        self.sharder.release(self.units[k])


class _Zero3Layer(torch.autograd.Function):
    """One layer of the ZeRO-3 loop (see the module docstring). The
    inputs after `x` are the layer unit's shards; their gradients are the
    reduce-scattered gradients of the layer's weights."""

    @staticmethod
    def forward(ctx, loop, k, run, x, *shards):
        loop.enter(k, +1)
        try:
            with torch.no_grad():
                y = run(x)
        finally:
            loop.leave(k)
        ctx.loop, ctx.k, ctx.run = loop, k, run
        ctx.save_for_backward(x)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, = ctx.saved_tensors
        loop, k = ctx.loop, ctx.k
        u = loop.units[k]
        need_dx = ctx.needs_input_grad[3]
        loop.enter(k, -1)
        try:
            flats = [torch.zeros(b.padded, dtype=b.dtype, device=b.device)
                     for b in u.buckets]
            params = []
            for b, f in zip(u.buckets, flats):
                for p, v in zip(b.params, b.views(f)):
                    if p.requires_grad:
                        p.grad = v
                        params.append(p)
            h = x.detach().requires_grad_(need_dx)
            with torch.enable_grad():
                y = ctx.run(h)
            inputs = ([h] if need_dx else []) + params
            if inputs:
                torch.autograd.backward(y, gy, inputs=inputs)
            dx = h.grad if need_dx else None
            for p in params:
                p.grad = None
        finally:
            loop.leave(k)
        parts = loop.sharder.reduce_scatter(u, flats)
        del flats
        return (None, None, None, dx) + tuple(
            part if b.shard.requires_grad else None
            for b, part in zip(u.buckets, parts))


def zero3_layer_loop(layers, x, args: tuple = (), kwargs: dict | None = None,
                     shard_info: ScanShardInfo | None = None):
    """``layer(x, *args, **kwargs)`` for each layer in order, through the
    ZeRO-3 loop of `shard_info` (see the module docstring)."""
    from paddle_tpu_torch.amp import fp8

    sess = fp8.current_session()
    if sess is not None and sess.mode != "stateless":
        # the backstop of TrainStep's refusal (JAX scan_layers.py:246-254):
        # the loop owns the layers' recompute and cannot thread the amax
        # histories
        raise ValueError(
            "fp8 delayed scaling cannot thread the zero_stage=3 "
            "sharded-weights scan; use zero_stage<=2 with fp8_policy")
    kwargs = kwargs or {}
    sharder = shard_info.sharder
    units = [sharder.unit_of(layer) for layer in layers]
    loop = _Zero3Loop(sharder, units, shard_info.mode)
    for k, (layer, u) in enumerate(zip(layers, units)):
        run = _replaying(lambda h, layer=layer: layer(h, *args, **kwargs))
        x = _Zero3Layer.apply(loop, k, run, x, *u.shards)
    return x
