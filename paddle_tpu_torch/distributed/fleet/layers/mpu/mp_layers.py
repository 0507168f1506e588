"""Megatron tensor-parallel layers (``paddle_tpu.distributed.fleet.layers.
mpu.mp_layers`` counterpart; reference: fleet/layers/mpu/mp_layers.py,
``VocabParallelEmbedding`` :47, ``ColumnParallelLinear`` :334,
``RowParallelLinear`` :541, ``ParallelCrossEntropy`` :742).

The JAX layers keep each parameter at its logical full shape with an
"mp" sharding and let GSPMD partition the program. Here each rank holds
its own shard as a ``torch.nn.Module`` parameter, in PyTorch's layout,
and the layer runs the Megatron collectives itself (``mp_ops``):

* ``ColumnParallelLinear``: weight ``[out / mp, in]``, rows
  ``[r out/mp, (r+1) out/mp)`` of the full ``[out, in]``; the input goes
  through ``_c_identity``, the output stays the local block unless
  ``gather_output``;
* ``RowParallelLinear``: weight ``[out, in / mp]``; the input is split
  unless ``input_is_parallel``, the partial products are summed by
  ``_mp_allreduce``, the replicated bias added after;
* ``VocabParallelEmbedding``: rows ``[r V/mp, (r+1) V/mp)``; ids outside
  the shard give zeros, summed back by ``_mp_allreduce``;
* ``ParallelCrossEntropy``: per-token softmax CE over vocab-sharded
  logits (max, sum of exp and target logit reduced over mp).

Sharded parameters carry ``mp_sharded = True`` (Paddle's
``is_distributed``, a name ``torch.Tensor`` already has as a method) and
``split_axis`` (their sharded dim in PyTorch's layout). The products go through
``nn.functional.linear``/``embedding``, the AMP seam of ``Projection``
(``models/llama.py``); fp8 and LoRA deltas under mp > 1 raise (ROADMAP
A8). Constructors take the JAX signatures plus ``device`` and ``dtype``;
over an mp group of one rank each layer computes what
``torch.nn.Linear``/``Embedding`` compute.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.amp import fp8 as amp_fp8
from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import (
    _c_concat, _c_identity, _c_split, _mp_allreduce)
from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
    mp_group as _group_of
from paddle_tpu_torch.lora import seam as lora_seam
from paddle_tpu_torch.nn import functional as F

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "MP_NOT_PORTED"]

MP_NOT_PORTED = ("{what} under tensor parallelism (mp > 1) is not ported "
                 "yet (ROADMAP A8)")


def _world(group):
    return 1 if group is None else group.nranks


def _rank(group):
    return 0 if group is None else group.rank


def _split(n: int, world: int, what: str) -> int:
    if n % world:
        raise ValueError(f"{what} {n} is not a multiple of the mp degree "
                         f"{world}")
    return n // world


def _param(shape, full_fan, device, dtype, split_axis=None):
    """A Xavier-normal parameter over the logical full fans (the JAX
    layers' default initializer)."""
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
    with torch.no_grad():
        p.normal_(0.0, math.sqrt(2.0 / sum(full_fan)))
    if split_axis is not None:
        p.mp_sharded = True
        p.split_axis = split_axis
    return p


def _check_seams(layer, x):
    if _world(layer.group) > 1:
        if amp_fp8.linear_fp8_enabled(x, layer.weight):
            raise NotImplementedError(MP_NOT_PORTED.format(what="fp8"))
        if lora_seam.active():
            raise NotImplementedError(MP_NOT_PORTED.format(what="LoRA"))


class VocabParallelEmbedding(nn.Module):
    """reference mp_layers.py:47: the vocabulary sharded over mp ranks."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__()
        self.group = _group_of(mp_group)
        self.world_size = _world(self.group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.per_rank = _split(num_embeddings, self.world_size, "vocab")
        self.vocab_start = _rank(self.group) * self.per_rank
        self.weight = _param((self.per_rank, embedding_dim),
                             (num_embeddings, embedding_dim), device, dtype,
                             0 if self.world_size > 1 else None)

    def forward(self, x):
        if self.world_size == 1:
            return F.embedding(x, self.weight)
        local = x - self.vocab_start
        hit = (local >= 0) & (local < self.per_rank)
        out = F.embedding(torch.where(hit, local, 0), self.weight)
        out = torch.where(hit[..., None], out, torch.zeros((), dtype=out.dtype,
                                                           device=out.device))
        return _mp_allreduce(out, self.group)


class ColumnParallelLinear(nn.Module):
    """reference mp_layers.py:334: the output features sharded."""

    torch_linear_layout = True    # weight [out, in] (checkpoint.layout)

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__()
        self.group = _group_of(mp_group)
        self.world_size = _world(self.group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.out_per_rank = _split(out_features, self.world_size,
                                   "out_features")
        split = 0 if self.world_size > 1 else None
        self.weight = _param((self.out_per_rank, in_features),
                             (in_features, out_features), device, dtype,
                             split)
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(self.out_per_rank,
                                                 device=device, dtype=dtype))
            if split is not None:
                self.bias.mp_sharded, self.bias.split_axis = True, 0

    def forward(self, x):
        _check_seams(self, x)
        y = F.linear(_c_identity(x, self.group), self.weight, self.bias)
        if self.gather_output:
            y = _c_concat(y, self.group)
        return y


class RowParallelLinear(nn.Module):
    """reference mp_layers.py:541: the input features sharded, the
    partial products summed over mp."""

    torch_linear_layout = True    # weight [out, in] (checkpoint.layout)

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__()
        self.group = _group_of(mp_group)
        self.world_size = _world(self.group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.in_per_rank = _split(in_features, self.world_size,
                                  "in_features")
        self.weight = _param((out_features, self.in_per_rank),
                             (in_features, out_features), device, dtype,
                             1 if self.world_size > 1 else None)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        _check_seams(self, x)
        if not self.input_is_parallel:
            x = _c_split(x, self.group)
        y = _mp_allreduce(F.linear(x, self.weight, None), self.group)
        if self.bias is not None:
            y = y + self.bias
        return y


def vocab_parallel_nll(logits, label, group, ignore_index=-100):
    """Per-token fp32 softmax CE of vocab-sharded logits ``[..., V/mp]``
    (rank r holds columns ``[r V/mp, (r+1) V/mp)``), ignored tokens 0: the
    max, the sum of exp and the target logit reduced over `group`. The
    gradient reaches the local logits only."""
    x = logits.float()
    vloc = x.shape[-1]
    if _world(group) == 1:
        lab = label.long()
        logp = torch.log_softmax(x, -1)
        t = -logp.gather(-1, lab.clamp(0, vloc - 1)[..., None])[..., 0]
        return torch.where(label != ignore_index, t, 0.0)
    m = x.detach().amax(-1)
    collective.all_reduce(m, collective.ReduceOp.MAX, group=group)
    se = _mp_allreduce(torch.exp(x - m[..., None]).sum(-1), group)
    local = label.long() - _rank(group) * vloc
    hit = (local >= 0) & (local < vloc)
    t = x.gather(-1, local.clamp(0, vloc - 1)[..., None])[..., 0]
    t = _mp_allreduce(torch.where(hit, t, 0.0), group)
    nll = m + torch.log(se) - t
    return torch.where(label != ignore_index, nll, 0.0)


class ParallelCrossEntropy(nn.Module):
    """reference mp_layers.py:742: softmax CE over logits whose vocabulary
    is sharded over mp; per-token fp32 losses, ignored tokens 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = _group_of(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        return vocab_parallel_nll(input, label, self.group,
                                  self.ignore_index)
