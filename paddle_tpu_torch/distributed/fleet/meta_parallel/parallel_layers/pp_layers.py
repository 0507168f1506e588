"""The pipeline's layer list (``paddle_tpu.distributed.fleet.meta_parallel.
parallel_layers.pp_layers`` counterpart; reference: fleet/meta_parallel/
parallel_layers/pp_layers.py, ``PipelineLayer`` :257, ``SegmentLayers``
:92, ``LayerDesc``/``SharedLayerDesc``).

The layer list is cut into ``num_stages * num_virtual_pipeline_stages``
parts (``SegmentLayers``, ``seg_method`` "uniform" or
"layer:<class-name regex>"); part p = chunk * S + stage, so pp rank s
holds parts s, S + s, ... (its V chunks). Unlike the JAX package, which
materializes every stage in its one process, a rank here builds only its
own parts: a 7B-width stage never builds the whole model. Built layers
are registered under their global index in the list (``"3.self_attn..."``),
so a state dict names a parameter the same way on every layout.

``SharedLayerDesc``: a layer whose key appears on several stages (tied
embeddings) is built once a rank and kept on each stage that uses it.
The copies start equal (broadcast from the first stage holding the
key), their gradients are summed over those stages
before the update (``allreduce_shared_weight_gradients``, Paddle's
shared-weight all-reduce), and only the first stage's copy counts in the
hybrid global norm (``is_firstly_shared``); the JAX package gets the same
sum from its single instance.

Layers are built on ``device`` (the card unless the caller asks for the
CPU). ``seeded_init_`` draws a layer's parameters from a generator seeded
by (seed, the layer's index in the list), the same values on any layout:
stage-local initialization for a caller that builds its stages alike.
"""
from __future__ import annotations

import math
import re
from functools import partial

import torch
from torch import nn

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "seeded_init_"]


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("LayerDesc expects an nn.Module subclass")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared across stages under `key` (reference pp_layers.py
    SharedLayerDesc); `forward_func(layer, x)` replaces ``layer(x)`` where
    given; `shared_weight_attr` names the shared parameter."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """reference: pp_layers.py:92 — cut N layers into `num_parts` parts."""

    def __init__(self, layers_desc, num_parts, method="uniform",
                 num_virtual_pipeline_stage=None):
        self._layers_desc = layers_desc
        self.method = method
        self.num_parts = num_parts
        self.num_items = len(layers_desc)
        if self.num_items < self.num_parts:
            raise ValueError(f"{self.num_items} layers cannot fill "
                             f"{self.num_parts} pipeline parts")

    def do_segment(self):
        if self.method == "uniform":
            return self.uniform(self.num_items, self.num_parts)
        if self.method.startswith("layer:"):
            # cut on the layers whose class name matches
            pat = self.method.split(":", 1)[1]
            weights = [0] * len(self._layers_desc)
            for i, d in enumerate(self._layers_desc):
                name = (d.layer_func.__name__ if isinstance(d, LayerDesc)
                        else type(d).__name__)
                if re.search(pat, name):
                    weights[i] = 1
            total = sum(weights)
            if total < self.num_parts:
                raise ValueError(f"{total} layers match {pat!r}; "
                                 f"{self.num_parts} parts need as many")
            result = [0] * (self.num_parts + 1)
            per = total / self.num_parts
            cnt, part = 0.0, 1
            for i, w in enumerate(weights):
                cnt += w
                if part < self.num_parts and cnt >= per * part and w:
                    result[part] = i
                    part += 1
            result[self.num_parts] = len(weights)
            return result
        raise ValueError(f"unknown segment method {self.method}")

    @staticmethod
    def uniform(num_items, num_parts):
        result = [0] * (num_parts + 1)
        part_size = math.floor(num_items / num_parts)
        extra = num_items % num_parts
        for i in range(1, num_parts + 1):
            result[i] = result[i - 1] + part_size + (1 if i <= extra else 0)
        return result


@torch.no_grad()
def seeded_init_(params, seed: int, index: int, std: float = 0.02):
    """Draw `params` (in order) from a generator on their device seeded by
    (`seed`, `index`): N(0, std) for tensors of two or more dims, ones for
    vectors. The pipeline's stage-local initialization: layer i of a list
    gets the same values on any layout."""
    params = list(params)
    if not params:
        return
    gen = torch.Generator(device=params[0].device)
    gen.manual_seed(int(seed) * 1000003 + int(index))
    for p in params:
        if p.dim() == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, std, generator=gen)


def block_run(descs) -> tuple[int, int]:
    """[start, end) of the longest run of the same ``LayerDesc`` class (not
    shared) in `descs`: the homogeneous blocks a remat policy wraps one
    by one (JAX ``_decompose_run``'s blocks)."""
    best, i, n = (0, 0), 0, len(descs)
    while i < n:
        d = descs[i]
        if not isinstance(d, LayerDesc) or isinstance(d, SharedLayerDesc):
            i += 1
            continue
        j = i + 1
        while (j < n and isinstance(descs[j], LayerDesc)
               and not isinstance(descs[j], SharedLayerDesc)
               and descs[j].layer_func is d.layer_func):
            j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    return best


class PipelineLayer(nn.Module):
    """reference: pp_layers.py:257. `num_stages` defaults to the hcg's pp
    degree and must equal it; this rank builds only its stage's parts."""

    layer_remat_capable = True

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        from paddle_tpu_torch.distributed import fleet

        self._layers_desc = list(layers)
        self._loss_fn = loss_fn
        self._recompute_interval = int(recompute_interval or 0)
        self.remat_policy = "full" if self._recompute_interval > 0 else None
        self._num_virtual_pipeline_stages = int(
            num_virtual_pipeline_stages or 1)
        hcg = fleet.get_hybrid_communicate_group()
        self._hcg = hcg
        pp = hcg.get_pipe_parallel_world_size()
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = int(num_stages or pp)
        if self._num_stages != pp:
            raise ValueError(
                f"num_stages={self._num_stages} but the hcg's pp degree is "
                f"{pp}: a rank builds only its own stage")
        self._stage_id = hcg.get_stage_id()
        self.device = resolve_device(device)
        S, V = self._num_stages, self._num_virtual_pipeline_stages
        seg = SegmentLayers(self._layers_desc, num_parts=S * V,
                            method=seg_method)
        self.segment_parts = seg.do_segment()
        self._block_range = block_run(self._layers_desc)

        # this rank's parts (chunk c = part c * S + stage), built locally
        self.shared_layers = nn.ModuleDict()
        self._parts = []            # [(position, [(index, fn)])]
        for c in range(V):
            p = c * S + self._stage_id
            items = []
            for i in range(self.segment_parts[p], self.segment_parts[p + 1]):
                items.append((i, self._build(i)))
            self._parts.append((p, items))
        self.run_function = [fn for _, items in self._parts
                             for _, fn in items]
        self._shared_groups = {}
        self._setup_shared()

    def _build(self, i):
        desc = self._layers_desc[i]
        if isinstance(desc, SharedLayerDesc):
            key = desc.layer_name
            if key not in self.shared_layers:
                with torch.device(self.device):
                    layer = desc.build_layer()
                self.shared_layers[key] = layer
            layer = self.shared_layers[key]
            if desc.forward_func is not None:
                return partial(desc.forward_func, layer)
            return layer
        if isinstance(desc, LayerDesc):
            with torch.device(self.device):
                layer = desc.build_layer()
            self.add_module(str(i), layer)
            return layer
        if isinstance(desc, nn.Module):
            self.add_module(str(i), desc)
            return desc
        if callable(desc):
            return desc
        raise TypeError(f"unsupported layer desc {desc!r}")

    def _setup_shared(self):
        """Groups over the stages holding each shared key (every rank
        builds every group, the c10d rule), the copies made equal, and
        ``is_firstly_shared`` on the shared parameters."""
        from paddle_tpu_torch.distributed import collective

        S = self._num_stages
        holders = {}
        for p in range(len(self.segment_parts) - 1):
            for i in range(self.segment_parts[p], self.segment_parts[p + 1]):
                d = self._layers_desc[i]
                if isinstance(d, SharedLayerDesc):
                    stages = holders.setdefault(d.layer_name, [])
                    if p % S not in stages:
                        stages.append(p % S)
        mesh = self._hcg.mesh
        for key in sorted(holders):
            stages = sorted(holders[key])
            layer = self.shared_layers[key] if key in self.shared_layers \
                else None
            if layer is not None:
                first = self._stage_id == stages[0]
                w = getattr(layer, self._shared_attr(key))
                w.is_firstly_shared = first
            if len(stages) < 2:
                continue
            mine = None
            for ranks in mesh._comm_lists(("pp",)):
                g = collective.new_group([ranks[s] for s in stages],
                                         name=f"shared_{key}")
                if g.is_member():
                    mine = g
            if mine is not None:
                self._shared_groups[key] = mine
                with torch.no_grad():
                    collective.broadcast(
                        getattr(layer, self._shared_attr(key)).data,
                        src=mine.ranks[0], group=mine)

    def _shared_attr(self, key):
        for d in self._layers_desc:
            if isinstance(d, SharedLayerDesc) and d.layer_name == key:
                return d.shared_weight_attr
        raise KeyError(key)

    @torch.no_grad()
    def allreduce_shared_weight_gradients(self):
        """Sum each shared parameter's gradient over the stages holding it
        (reference ``PipelineLayer.allreduce_shared_weight_gradients``)."""
        from paddle_tpu_torch.distributed import collective

        for key, g in self._shared_groups.items():
            w = getattr(self.shared_layers[key], self._shared_attr(key))
            grad = w.grad if w.grad is not None else torch.zeros_like(w)
            collective.all_reduce(grad, group=g)
            w.grad = grad

    # ---- layout -----------------------------------------------------------
    @property
    def num_stages(self):
        return self._num_stages

    def get_num_stages(self):
        return self._num_stages

    def get_stage_id(self):
        return self._stage_id

    def stage_boundaries(self):
        return list(self.segment_parts)

    def parts(self):
        """This rank's parts in chunk order: [(position, [(index, fn)])]."""
        return list(self._parts)

    def is_block(self, index: int) -> bool:
        """Whether list index `index` is one of the homogeneous blocks a
        remat policy wraps."""
        return self._block_range[0] <= index < self._block_range[1]

    def layers_of_stage(self, stage_id):
        """The callables of stage `stage_id`'s parts; a rank holds only its
        own stage's."""
        if stage_id != self._stage_id:
            raise ValueError(f"this rank builds stage {self._stage_id} "
                             f"only, not {stage_id}")
        return list(self.run_function)

    def forward(self, input, chunk_id=None):
        """This rank's parts (or part `chunk_id`) on `input`, in order."""
        parts = (self._parts if chunk_id is None
                 else [self._parts[chunk_id]])
        x = input
        for _, items in parts:
            for _, fn in items:
                x = fn(*x) if isinstance(x, tuple) else fn(x)
        return x

    def loss(self, output, label):
        if self._loss_fn is None:
            raise RuntimeError("PipelineLayer built without loss_fn")
        return self._loss_fn(output, label)
