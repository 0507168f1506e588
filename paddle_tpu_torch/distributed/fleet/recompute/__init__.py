"""Activation recomputation (``paddle_tpu.distributed.fleet.recompute``
counterpart; reference: fleet/recompute/recompute.py and
recompute_hybrid.py, checkpointing with RNG-state replay).

``recompute(function, *args)`` runs `function` under
``torch.utils.checkpoint`` (non-reentrant): the forward keeps no
activation of `function`, and the backward runs it again. Gradients reach
the inputs and every tensor the function reads, so ``recompute(block,
x)`` trains the block's weights, as the JAX package's does through
``functional_call``. It works on torch modules and on the Paddle API's
``Layer`` and ``Tensor`` alike.

The second run replays the first one's state, which autograd's backward
thread (a CUDA backward runs on its device thread) does not have: the
AMP state, the fp8 session and its callsite cursor, the packed-batch and
sep contexts (``parallel.scan_layers._replaying``), and, with
``preserve_rng_state``, the random state. The port's random ops draw
from explicit generators (``ops.random_state.active_generator``: the
global ``Generator``'s, or a ``fleet.rng`` tracker stream's), which
torch's ``preserve_rng_state`` does not see; so the recompute starts
every such generator from its state before the first run (a generator
the first run created from its seed) with the same tracker scope active,
and afterwards puts back the states the first run left. A recomputed
dropout draws the first run's mask, and the generators go on as if drawn
once. (The JAX package's dropout keys are captured values of the traced
function, so its recompute replays them by construction.)

``use_reentrant`` is accepted for the reference's signature; the
recompute is always non-reentrant.
"""
from __future__ import annotations

import torch.utils.checkpoint as _ckpt

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid"]


def _generators() -> list:
    """(torch.Generator, seed) of every explicit generator of the port:
    the global ``Generator``'s per device, then every tracker stream's."""
    from paddle_tpu_torch.distributed.fleet.rng import get_rng_state_tracker
    from paddle_tpu_torch.ops import random_state

    g = random_state.default_generator
    out = [(gen, g.initial_seed()) for gen in list(g._gens.values())]
    tracker = get_rng_state_tracker()
    for name, gens in tracker.states_.items():
        out += [(gen, tracker.seeds_[name]) for gen in list(gens.values())]
    return out


def _rng_replaying(fn):
    """`fn` whose second and later runs draw what its first run drew."""
    from paddle_tpu_torch.ops import random_state

    first = {}

    def run(*a):
        if not first:
            first["scope"] = getattr(random_state._active, "fn", None)
            first["states"] = {id(g): g.get_state() for g, _ in _generators()}
            return fn(*a)
        gens = _generators()
        after = [(g, g.get_state()) for g, _ in gens]
        scope = getattr(random_state._active, "fn", None)
        for g, seed in gens:
            st = first["states"].get(id(g))
            if st is None:       # the first run created it from its seed
                g.manual_seed(seed)
            else:
                g.set_state(st)
        random_state._active.fn = first["scope"]
        try:
            return fn(*a)
        finally:
            random_state._active.fn = scope
            for g, st in after:
                g.set_state(st)

    return run


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              **kwargs):
    """reference fleet/recompute/recompute.py ``recompute(fn, *args)``:
    ``function(*args, **kwargs)`` with its activations recomputed in the
    backward (see the module docstring)."""
    from paddle_tpu_torch.parallel.scan_layers import _replaying

    def call(*a):
        return function(*a, **kwargs)

    run = _replaying(_rng_replaying(call) if preserve_rng_state else call)
    return _ckpt.checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=preserve_rng_state)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Each of `functions` under its own ``recompute``, in order."""
    out = args
    for fn in functions:
        out = (recompute(fn, *out),)
    return out[0]


def recompute_hybrid(ctx, function, *args, **kwargs):
    """reference recompute_hybrid.py: the hybrid-parallel variant. The
    offload and partition hints in `ctx` are not applied (as in the JAX
    package): the recompute runs on this rank's device."""
    return recompute(function, *args, **kwargs)
