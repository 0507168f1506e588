"""``SegmentParallel``, the sequence (segment) parallel wrapper over the
"sep" axis (``paddle_tpu.distributed.fleet.meta_parallel.
segment_parallel`` counterpart; reference: fleet/meta_parallel/
segment_parallel.py:26).

At wrap it broadcasts the parameters over the sep group, then over the
sharding and dp groups, so every sep rank starts from the same weights.
Each sep rank then runs its own contiguous segment of every row's
sequence (``shard_sequence`` cuts it in eager code; ``TrainStep(mesh=)``
cuts a global batch itself), and attention crosses the segments by ring
attention (``parallel.ring_attention``): the forward publishes the sep
group (``parallel.segments.sep_execution``), so the LLaMA's attention
rings over it, its RoPE positions are the segment's and its own loss is
the rank's share of the rows' mean. Only a model that declares
``supports_sep`` (``LlamaForCausalLM``) is taken at sep > 1, and a
training forward must return that share (call the model with its
``labels``): any other model would attend within its segment and mean
its own tokens, so both raise (ROADMAP A8). It does not reduce gradients:
``HybridParallelOptimizer`` sums them over dp x sep and divides by dp at
its step, or ``fused_allreduce_gradients`` does where an eager loop
calls it.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (
    broadcast_dp_parameters, broadcast_sep_parameters,
    broadcast_sharding_parameters)
from paddle_tpu_torch.parallel.segments import (current_sep_group,
                                                sep_execution, sep_loss)

__all__ = ["SegmentParallel"]


def check_supports_sep(model):
    """Raise unless `model` (or the model a wrapper holds) declares that it
    runs under a sep group: its attention rings over the group and its
    criterion shares the loss."""
    inner = model
    while not hasattr(type(inner), "supports_sep") and \
            isinstance(getattr(inner, "_layers", None), nn.Module):
        inner = inner._layers
    if not getattr(type(inner), "supports_sep", False):
        raise NotImplementedError(
            f"sequence parallelism (sep > 1) for {type(inner).__name__} is "
            f"not ported yet (ROADMAP A8): its attention would see only its "
            f"own segment and its loss mean only its own tokens; "
            f"LlamaForCausalLM runs under sep")


class SegmentParallel(nn.Module):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        if hcg is None:
            return
        if hcg.get_sep_parallel_world_size() > 1:
            check_supports_sep(layers)
        broadcast_sep_parameters(layers, hcg)
        if hcg.get_sharding_parallel_world_size() > 1:
            broadcast_sharding_parameters(layers, hcg)
        if hcg.get_data_parallel_world_size() > 1:
            broadcast_dp_parameters(layers, hcg)

    def shard_sequence(self, x, seq_axis: int = 1):
        """This sep rank's contiguous segment of `x` along `seq_axis`:
        positions ``[r S/n, (r + 1) S/n)`` for sep coordinate r of n. The
        length must divide by n."""
        hcg = self._hcg
        n = hcg.get_sep_parallel_world_size() if hcg is not None else 1
        if n <= 1:
            return x
        r = hcg.get_sep_parallel_rank()
        seqlen = x.shape[seq_axis]
        if seqlen % n != 0:
            raise ValueError(f"sequence length {seqlen} not divisible by sep "
                             f"degree {n}")
        per = seqlen // n
        index = [slice(None)] * x.dim()
        index[seq_axis] = slice(r * per, (r + 1) * per)
        return x[tuple(index)]

    def forward(self, *args, **kwargs):
        group = (self._hcg.get_sep_parallel_group()
                 if self._hcg is not None else None)
        if current_sep_group() is group:
            # a step published the group already and checks its loss
            return self._layers(*args, **kwargs)
        with sep_execution(group):
            out = self._layers(*args, **kwargs)
            if (group is not None and group.nranks > 1 and self.training
                    and torch.is_grad_enabled() and out is not sep_loss()):
                raise ValueError(
                    "a training forward under sequence parallelism (sep > "
                    "1) must return the model's own loss share: call it "
                    "with its labels (a loss taken from its logits would "
                    "mean the rank's segment alone; ROADMAP A8)")
            return out

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict
