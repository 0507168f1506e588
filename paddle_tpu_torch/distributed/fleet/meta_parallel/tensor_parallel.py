"""``TensorParallel`` (``paddle_tpu.distributed.fleet.meta_parallel.
tensor_parallel`` counterpart; reference: fleet/meta_parallel/
tensor_parallel.py:28).

At wrap it broadcasts the parameters replicated across the mp group
(the mp shards stay per rank), then the sep, sharding and dp ones, in the
reference's ``_prepare_for_model`` order, and last the ones replicated
across the ep group (the experts' blocks stay per rank). It does not
average gradients: ``HybridParallelOptimizer`` does that over the dp
group (dp x ep under expert parallelism) at its step.
"""
from __future__ import annotations

from torch import nn

from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (
    broadcast_dp_parameters, broadcast_ep_parameters, broadcast_mp_parameters,
    broadcast_sep_parameters, broadcast_sharding_parameters)

__all__ = ["TensorParallel"]


class TensorParallel(nn.Module):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        broadcast_mp_parameters(layers, hcg)
        if hcg.get_sep_parallel_world_size() > 1:
            broadcast_sep_parameters(layers, hcg)
        if hcg.get_sharding_parallel_world_size() > 1:
            broadcast_sharding_parameters(layers, hcg)
        if hcg.get_data_parallel_world_size() > 1:
            broadcast_dp_parameters(layers, hcg)
        if hcg.get_expert_parallel_world_size() > 1:
            broadcast_ep_parameters(layers, hcg)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

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
