"""Packed-sequence metadata for the layers a pipeline stage runs
(``paddle_tpu.parallel.segments`` counterpart).

The pipelined runtimes (1F1B and VPP ``PipelinedTrainStep``, ZB-H1
``ZBH1PipelinedStep``) move only the hidden state between stages; a
packed batch's ``segment_ids``/``position_ids`` cannot ride the
activation without changing every stage's wire format. So the runtimes
publish the current microbatch's ids in a thread-local context for the
duration of each stage call, and segment-aware layers
(``LlamaAttention``) read it when their explicit
``segment_ids``/``position_ids`` are None. Layers that ignore the
context are untouched.

A training step under sequence parallelism publishes its sep group the
same way (``sep_execution``): ``LlamaAttention`` then runs ring attention
over it and takes its RoPE positions at the rank's segment of the
sequence, and ``LlamaPretrainingCriterion`` reduces to the rank's share
of the group's mean loss and records it (``note_sep_loss``), so a step
can check that it trains on that share and not on a local mean.

A remat policy recomputes a layer in the backward, which CUDA runs on
autograd's device thread: ``scan_layers.unrolled_layer_call`` replays the
contexts of the first run there, as it replays the AMP state.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["segment_execution", "current_segment_ctx", "SegmentContext",
           "sep_execution", "current_sep_group", "note_sep_loss",
           "sep_loss"]


class SegmentContext:
    """segment_ids / position_ids of the microbatch a stage is running
    ([mb, S] tensors, or None for the unpacked case)."""

    __slots__ = ("segment_ids", "position_ids")

    def __init__(self, segment_ids=None, position_ids=None):
        self.segment_ids = segment_ids
        self.position_ids = position_ids


class _TLS(threading.local):
    def __init__(self):
        self.ctx = None
        self.sep = None
        self.sep_loss = None


_tls = _TLS()


def current_segment_ctx() -> SegmentContext | None:
    return _tls.ctx


@contextmanager
def segment_execution(segment_ids=None, position_ids=None):
    """Publish packed-batch metadata to the layers run inside the block.
    A context with both None still masks any outer one, so a stage never
    sees another microbatch's ids."""
    prev = _tls.ctx
    _tls.ctx = SegmentContext(segment_ids, position_ids)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


@contextmanager
def restored_segment_ctx(ctx: SegmentContext | None):
    """Install `ctx` (a ``current_segment_ctx()`` taken earlier, or None)
    for the block: the recompute of a remat region replays it."""
    prev = _tls.ctx
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def current_sep_group():
    """The sep group a step published (``sep_execution``), or None."""
    return _tls.sep


@contextmanager
def sep_execution(group):
    """Publish `group` (a ``collective.Group`` of the sep axis, or None)
    as the sequence-parallel group of the layers run inside the block.
    The block starts with no loss share recorded."""
    prev = _tls.sep, _tls.sep_loss
    _tls.sep, _tls.sep_loss = group, None
    try:
        yield group
    finally:
        _tls.sep, _tls.sep_loss = prev


def note_sep_loss(loss):
    """Record `loss`, a criterion's share of the sep group's mean loss,
    as the block's; returns it."""
    _tls.sep_loss = loss
    return loss


def sep_loss():
    """The loss share the criterion recorded in this ``sep_execution``
    block, or None."""
    return _tls.sep_loss
