"""ZeRO-3, the sharded-parameter core, and Paddle's group-sharded API
(``paddle_tpu.distributed.fleet.meta_parallel.sharding.group_sharded``
counterpart; reference: fleet/meta_parallel/sharding,
``GroupShardedOptimizerStage2`` group_sharded_optimizer_stage2.py:53,
``GroupShardedStage2`` group_sharded_stage2.py:46, ``GroupShardedStage3``
group_sharded_stage3.py:85).

The JAX package shards a parameter by its array sharding and lets GSPMD
place the all-gathers and reduce-scatters. The port runs a process per
rank, so the gathers are explicit, a unit at a time:

* **Units.** A unit is one module's parameters: each decoder layer of the
  model's ``scan_group()`` (the layer loop's units), and every other
  module that owns parameters directly (the embedding, the final norm and
  the head of a LLaMA: the outer units). Under mp a unit holds this
  rank's mp shards.
* **Flat buffers.** A unit's parameters of one dtype are packed into one
  flat buffer, padded with zeros to a multiple of the group size N; a
  rank keeps its contiguous 1/N of it (``shard``, a leaf tensor) and
  nothing else: the parameters themselves hold no data between uses. Each
  parameter's part of the shard (``slices``, a view, empty where the rank
  holds none of it) is what the optimizer updates, in the parameters'
  order, with the ``mp_sharded`` and ``is_firstly_shared`` marks of its
  parameter. A unit costs one all-gather and one reduce-scatter.
* **Gather and release.** ``gather(unit)`` fills the full buffers (an
  all-gather started by ``prefetch`` is waited on) and points the unit's
  parameters (``.data``) at views of them, so autograd and the optimizer
  keep seeing the same ``nn.Parameter`` objects; ``release(unit)`` points
  them at empty tensors and drops the buffers. ``scatter_grads(unit)``
  reduce-scatters the full gradients (``.grad``) into the shards'
  gradients and drops the full ones.
* **Counters.** ``live_units``: the full units allocated now;
  ``peak_units``: its peak since ``reset_peak()``; ``alive_buffers()``:
  the full buffers some reference (a view, a saved tensor) still keeps,
  released or not.

Two lifecycles use the core. The layer loop
(``parallel.scan_layers.layer_execution(shard_info=)``) gathers a layer
for its forward and again for its backward, where it recomputes the layer
and reduce-scatters the layer's gradients at once. A held unit is
gathered by ``begin()`` and stays gathered through the backward, its
gradients accumulating in ``.grad``; ``finish()``, after the backward,
reduce-scatters them and releases it (the outer units, and ZB-H1's
blocks). Every rank reduce-scatters every trainable held unit there, a
parameter without a gradient counting as zeros, so ranks whose batches
used different parameters still run the same collectives.

``GroupShardedStage3`` wraps a model in this core; ``group_sharded_parallel``
assembles the levels ``"os"`` (ZeRO-1), ``"os_g"`` (ZeRO-2) and
``"p_g_os"`` (ZeRO-3) on the port's ``DygraphShardingOptimizer``.
"""
from __future__ import annotations

import weakref

import torch
from torch import nn

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (
    is_mp_sharded)

__all__ = ["GroupShardedStage2", "GroupShardedStage3",
           "GroupShardedOptimizerStage2", "group_sharded_parallel",
           "ParamSharder", "Unit", "pick_shard_axis", "shard_group"]


def pick_shard_axis() -> str:
    """The ZeRO axis: 'sharding' when the mesh has one above 1, else
    'dp'."""
    from paddle_tpu_torch.distributed.mesh import mesh_axis_size

    return "sharding" if mesh_axis_size("sharding") > 1 else "dp"


def _solo():
    from paddle_tpu_torch.distributed.env import get_rank

    return collective.Group(id=-1, ranks=(get_rank(),), pg=None, name="")


def shard_group(group=None):
    """`group`, else the rank mesh's group along ``pick_shard_axis()``,
    else the world."""
    if group is not None:
        return group
    from paddle_tpu_torch.distributed.mesh import get_mesh

    mesh = get_mesh()
    if mesh is not None:
        return mesh.group(pick_shard_axis())
    return collective.get_group(0)


class _Bucket:
    """One dtype's parameters of a unit in one flat buffer (see the module
    docstring): `per` elements a rank, `padded` = N * per in all."""

    def __init__(self, params, group):
        self.params = list(params)
        self.shapes = [tuple(p.shape) for p in self.params]
        self.numels = [p.numel() for p in self.params]
        self.offsets = []
        total = 0
        for k in self.numels:
            self.offsets.append(total)
            total += k
        self.total = total
        n, r = group.nranks, group.rank
        self.per = max(1, -(-total // n))
        self.padded = self.per * n
        lo = r * self.per
        p0 = self.params[0]
        self.dtype, self.device = p0.dtype, p0.device
        with torch.no_grad():
            flat = torch.cat([p.detach().reshape(-1) for p in self.params]
                             + [p0.new_zeros(self.padded - total)])
            self.shard = flat[lo:lo + self.per].clone()
        self.shard.requires_grad_(any(p.requires_grad for p in self.params))
        base = self.shard.detach()
        self.slices, self.ranges = [], []
        for p, o, k in zip(self.params, self.offsets, self.numels):
            # the parameter's part of [lo, lo + per), in shard offsets
            a = min(max(o - lo, 0), self.per)
            e = max(min(o + k - lo, self.per), a)
            s = base[a:e]
            s.requires_grad_(p.requires_grad)
            s.mp_sharded = is_mp_sharded(p)
            if hasattr(p, "is_firstly_shared"):
                s.is_firstly_shared = p.is_firstly_shared
            self.slices.append(s)
            self.ranges.append((a, e))

    def views(self, flat):
        """The parameters' views of a full flat buffer."""
        return [flat[o:o + k].view(s) for o, k, s in
                zip(self.offsets, self.numels, self.shapes)]

    def flat_of(self, tensors):
        """The parameters' full tensors (None as zeros) in one padded flat
        buffer."""
        parts = [(t.reshape(-1).to(self.dtype) if t is not None else
                  torch.zeros(k, dtype=self.dtype, device=self.device))
                 for t, k in zip(tensors, self.numels)]
        parts.append(torch.zeros(self.padded - self.total, dtype=self.dtype,
                                 device=self.device))
        return torch.cat(parts)


class Unit:
    """One module's parameters, packed into a bucket per dtype.
    `loop`: a unit of the layer loop (else a held unit)."""

    def __init__(self, name, named_params, group, loop):
        self.name, self.loop = name, bool(loop)
        by_dtype = {}
        for n, p in named_params:
            by_dtype.setdefault(p.dtype, []).append((n, p))
        self.buckets = [_Bucket([p for _, p in nps], group)
                        for nps in by_dtype.values()]
        # names and parameters in bucket order
        self.names = [n for nps in by_dtype.values() for n, _ in nps]
        self.params = [p for b in self.buckets for p in b.params]
        self.full = None          # the full flat buffers while gathered
        self.works = None         # their all-gathers while in flight
        self.pinned = False       # get_all_parameters() left it gathered
        for bi, b in enumerate(self.buckets):
            for i, p in enumerate(b.params):
                p._zero3 = (self, bi, i)
        self._empty()

    @property
    def shards(self):
        return [b.shard for b in self.buckets]

    def _empty(self):
        for b in self.buckets:
            for p in b.params:
                p.data = torch.empty(0, dtype=b.dtype, device=b.device)

    @property
    def gathered(self) -> bool:
        return self.full is not None


class ParamSharder:
    """The units of a model over one sharding `group` (see the module
    docstring)."""

    def __init__(self, group):
        self.group = group
        self.units: list[Unit] = []
        self._by_module = {}
        self.live_units = self.peak_units = 0
        self._buffers = weakref.WeakSet()

    # ---- construction -------------------------------------------------------
    def add_unit(self, name, module, named_params, loop=False):
        named = [(n, p) for n, p in named_params
                 if getattr(p, "_zero3", None) is None]
        if not named:
            return None
        u = Unit(name, named, self.group, loop)
        u.sharder = self
        self.units.append(u)
        self._by_module[id(module)] = u
        return u

    @classmethod
    def for_model(cls, model, group):
        """The units of `model`: its ``scan_group()`` layers as loop units,
        then, in module order, every other module that owns parameters
        directly as held units. Parameter names are `model`'s."""
        sharder = cls(group)
        loops = list(model.scan_group() if hasattr(model, "scan_group")
                     else [])
        inside = {id(m) for lm in loops for m in lm.modules()}
        names = {id(m): n for n, m in model.named_modules()}
        for lm in loops:
            prefix = names.get(id(lm), "")
            sharder.add_unit(prefix, lm, [
                (f"{prefix}.{n}" if prefix else n, p)
                for n, p in lm.named_parameters()], loop=True)
        for name, m in model.named_modules():
            if id(m) in inside:
                continue
            direct = [(f"{name}.{n}" if name else n, p)
                      for n, p in m.named_parameters(recurse=False)]
            sharder.add_unit(name, m, direct)
        return sharder

    def unit_of(self, module) -> Unit:
        return self._by_module[id(module)]

    @property
    def loop_units(self):
        return [u for u in self.units if u.loop]

    @property
    def held_units(self):
        return [u for u in self.units if not u.loop]

    # ---- counters -------------------------------------------------------
    def reset_peak(self):
        self.peak_units = self.live_units

    def _track(self, sign):
        self.live_units += sign
        self.peak_units = max(self.peak_units, self.live_units)

    def alive_buffers(self) -> int:
        """The full buffers still referenced from anywhere."""
        return len(self._buffers)

    def resident_bytes(self) -> int:
        """The bytes of this rank's shards."""
        return sum(b.shard.numel() * b.shard.element_size()
                   for u in self.units for b in u.buckets)

    def full_bytes(self) -> int:
        """The bytes of the units' parameters, unpadded."""
        return sum(b.total * b.shard.element_size()
                   for u in self.units for b in u.buckets)

    # ---- gather and release ---------------------------------------------
    def prefetch(self, u: Unit):
        """Start `u`'s all-gathers (nothing when it is gathered or in
        flight)."""
        if u.full is not None:
            return
        u.full = [torch.empty(b.padded, dtype=b.dtype, device=b.device)
                  for b in u.buckets]
        for f in u.full:
            self._buffers.add(f)
        u.works = [collective.all_gather_async(f, b.shard.detach(),
                                               self.group)
                   for f, b in zip(u.full, u.buckets)]
        self._track(+1)

    def gather(self, u: Unit):
        """`u`'s full parameters: wait for its all-gathers (started now if
        need be) and point the parameters at views of the buffers."""
        self.prefetch(u)
        if u.works is not None:
            for w in u.works:
                w.wait()
            u.works = None
            for b, f in zip(u.buckets, u.full):
                for p, v in zip(b.params, b.views(f)):
                    p.data = v

    def release(self, u: Unit):
        """Drop `u`'s full buffers; its parameters hold no data."""
        if u.full is None:
            return
        if u.works is not None:
            for w in u.works:
                w.wait()
        u.full = u.works = None
        u.pinned = False
        u._empty()
        self._track(-1)

    def reduce_scatter(self, u: Unit, flats):
        """This rank's part of the group's sum of full flat gradients
        `flats` (one a bucket), one tensor a bucket."""
        out = []
        for b, f in zip(u.buckets, flats):
            part = torch.empty(b.per, dtype=b.dtype, device=b.device)
            collective.reduce_scatter(part, f, group=self.group)
            out.append(part)
        return out

    @torch.no_grad()
    def scatter_grads(self, u: Unit):
        """Reduce-scatter a held unit's ``.grad`` (None as zeros) into its
        shards' gradients and drop the full ones (nothing for a unit
        without a trainable parameter)."""
        if not any(b.shard.requires_grad for b in u.buckets):
            return
        flats = [b.flat_of([p.grad for p in b.params]) for b in u.buckets]
        for p in u.params:
            p.grad = None
        for b, part in zip(u.buckets, self.reduce_scatter(u, flats)):
            if not b.shard.requires_grad:
                continue
            if b.shard.grad is None:
                b.shard.grad = part
            else:
                b.shard.grad.add_(part)

    # ---- the held lifecycle ---------------------------------------------
    def begin(self):
        """Before a forward: release the units ``gather_all`` left
        gathered, then gather the held units."""
        for u in self.units:
            if u.pinned:
                self.release(u)
        held = self.held_units
        for u in held:
            self.prefetch(u)
        for u in held:
            self.gather(u)

    def finish(self):
        """After a backward: reduce-scatter the gathered held units'
        gradients and release every gathered unit."""
        for u in self.units:
            if u.gathered and not u.loop:
                self.scatter_grads(u)
        for u in self.units:
            self.release(u)

    def gather_all(self):
        """Gather every unit and leave it gathered (until the next
        ``begin``)."""
        for u in self.units:
            self.prefetch(u)
        for u in self.units:
            self.gather(u)
            u.pinned = True

    # ---- state ----------------------------------------------------------
    @torch.no_grad()
    def full_state(self) -> dict:
        """{name: full parameter} (copies), gathering each unit that is not
        gathered and releasing it again."""
        out = {}
        for u in self.units:
            was = u.gathered
            self.gather(u)
            for n, p in zip(u.names, u.params):
                out[n] = p.detach().clone()
            if not was:
                self.release(u)
        return out

    @torch.no_grad()
    def load_full_state(self, state: dict):
        """Keep this rank's part of every unit's full parameters in `state`
        ({name: tensor or array}); a gathered unit is released."""
        import numpy as np

        r = self.group.rank
        for u in self.units:
            self.release(u)
            vals = {}
            for n in u.names:
                v = state[n]
                if isinstance(v, np.ndarray):
                    v = torch.from_numpy(np.ascontiguousarray(v))
                vals[n] = v
            i = 0
            for b in u.buckets:
                names = u.names[i:i + len(b.params)]
                i += len(b.params)
                flat = b.flat_of([vals[n].to(b.device) for n in names])
                b.shard.detach().copy_(flat[r * b.per:(r + 1) * b.per])


def _unwrap(model):
    """The plain model inside the fleet wrappers (``_layers``)."""
    while isinstance(getattr(model, "_layers", None), nn.Module):
        model = model._layers
    return model


def _broadcast(tensors, group):
    """Each tensor from the group's first rank, in place."""
    if group.nranks > 1:
        with torch.no_grad():
            for t in tensors:
                collective.broadcast(t, src=group.ranks[0], group=group)


class _Groups:
    """The hcg methods the sharding optimizer and the hybrid clip call,
    over explicit groups (the group-sharded API runs without fleet)."""

    def __init__(self, sharding, dp=None):
        self._sharding = sharding
        self._dp = dp if dp is not None else _solo()

    def get_sharding_parallel_group(self):
        return self._sharding

    def get_sharding_parallel_world_size(self):
        return self._sharding.nranks

    def get_data_parallel_group(self):
        return self._dp

    def get_model_parallel_group(self):
        return _solo()

    def get_pipe_parallel_group(self):
        return _solo()

    def get_expert_parallel_group(self):
        return _solo()

    def get_sep_parallel_group(self):
        return _solo()


class GroupShardedOptimizerStage2:
    """Optimizer-state sharding over `group` (reference
    group_sharded_optimizer_stage2.py:53): the port's
    ``DygraphShardingOptimizer`` around `optim` (ZeRO-1; ZeRO-2 once a
    ``GroupShardedStage2`` wraps the model; ZeRO-3 for parameters a
    ``GroupShardedStage3`` sharded). A global-norm clip becomes the hybrid
    clip over the group. `offload` is not ported (ROADMAP A8)."""

    def __init__(self, params, optim, group=None, offload=False,
                 device=None, dp_group=None, **kwargs):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
            dygraph_sharding_optimizer import DygraphShardingOptimizer
        from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
            hybrid_parallel_optimizer import HybridParallelClipGrad
        from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

        if offload:
            raise NotImplementedError("group-sharded offload is not ported "
                                      "(ROADMAP A8)")
        self._groups = _Groups(shard_group(group), dp_group)
        if isinstance(getattr(optim, "_grad_clip", None),
                      ClipGradByGlobalNorm):
            optim._grad_clip = HybridParallelClipGrad(
                optim._grad_clip, self._groups, sharded=True, sum_pp=False)
        stage = 3 if any(getattr(p, "_zero3", None) is not None
                         for p in optim._params) else int(
                             kwargs.get("stage", 1))
        self._optim = DygraphShardingOptimizer(optim, self._groups,
                                               stage=stage, sum_pp=False)

    def __getattr__(self, name):
        return getattr(self.__dict__["_optim"], name)

    def step(self):
        self._optim.step()

    def clear_grad(self, *a, **k):
        self._optim.clear_grad()

    clear_gradients = clear_grad

    def state_dict(self):
        return self._optim.state_dict()

    def set_state_dict(self, s):
        return self._optim.set_state_dict(s)


class GroupShardedStage2(nn.Module):
    """ZeRO-2 (reference group_sharded_stage2.py:46): the sharding
    optimizer reduce-scatters each gradient as soon as the backward
    completes it and drops the full one. `sync_buffers` broadcasts the
    model's buffers over the group at wrap."""

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device=None, dp_group=None,
                 **kwargs):
        super().__init__()
        self._layers = layer
        inner = getattr(sharding_optimizer, "_optim", sharding_optimizer)
        inner.enable_grad_hooks()
        if sync_buffers:
            _broadcast(layer.buffers(), shard_group(group))

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)


class GroupShardedStage3(nn.Module):
    """ZeRO-3 (reference group_sharded_stage3.py:85): `layer`'s parameters
    persist as this rank's 1/N of each unit (``ParamSharder.for_model``
    over `group`, default the mesh's ``pick_shard_axis()`` group). A
    forward gathers the held units, runs the decoder layers through the
    ZeRO-3 layer loop (`zero3_gather`: "ahead" or "start", None reads the
    flag; the attribute of that name reads and sets it) and leaves the
    held units gathered for the backward; the sharding optimizer's step
    (or ``release()``) reduce-scatters their gradients and frees them.
    `pretrain_sync_models` broadcasts the
    parameters (and `sync_buffers` the buffers) from the group's first
    rank before they are sharded.

    ``get_all_parameters()`` gathers every unit and leaves it gathered
    until the next forward; ``state_dict()`` returns the full parameters
    (copies) under the plain model's names, with its persistent buffers;
    ``set_state_dict()`` re-shards full parameters."""

    def __init__(self, layer, optimizer=None, group=None,
                 sync_buffers=False, device=None, segment_size=2 ** 20,
                 pretrain_sync_models=True, offload=False, sync_comm=False,
                 dp_group=None, exclude_layer=None, zero3_gather=None,
                 **kwargs):
        super().__init__()
        from paddle_tpu_torch.core.flags import flag
        from paddle_tpu_torch.parallel.scan_layers import ScanShardInfo

        if offload:
            raise NotImplementedError("group-sharded offload is not ported "
                                      "(ROADMAP A8)")
        self._layers = layer
        group = shard_group(group)
        mode = str(flag("zero3_gather") if zero3_gather is None
                   else zero3_gather)
        self._info = ScanShardInfo(None, mode)
        plain = _unwrap(layer)
        if pretrain_sync_models:
            _broadcast([p.data for p in plain.parameters()], group)
        if sync_buffers:
            _broadcast(plain.buffers(), group)
        self.sharder = ParamSharder.for_model(plain, group)
        self._info.sharder = self.sharder
        self._plain = [plain]   # not a submodule: no second registration

    def forward(self, *args, **kwargs):
        from paddle_tpu_torch.parallel.scan_layers import (current_layer_ctx,
                                                           layer_execution)

        cur = current_layer_ctx()
        policy = cur.policy if cur is not None else "none"
        self.sharder.begin()
        with layer_execution(policy, shard_info=self._info):
            return self._layers(*args, **kwargs)

    @property
    def zero3_gather(self) -> str:
        """The layer loop's gather schedule, "ahead" or "start"."""
        return self._info.mode

    @zero3_gather.setter
    def zero3_gather(self, mode):
        from paddle_tpu_torch.parallel.scan_layers import ScanShardInfo

        self._info = ScanShardInfo(self.sharder, str(mode))

    def release(self):
        """Reduce-scatter the held units' gradients and free every full
        buffer (the sharding optimizer's step does it first)."""
        self.sharder.finish()

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)

    def get_all_parameters(self, convert2cpu=False):
        """reference stage-3 API: gather every unit and leave the
        parameters full."""
        self.sharder.gather_all()
        params = list(self._plain[0].parameters())
        if convert2cpu:
            return [p.detach().cpu() for p in params]
        return params

    def state_dict(self, *a, **k):
        plain = self._plain[0]
        out = self.sharder.full_state()
        names = {n for n, _ in plain.named_parameters()}
        for n, v in plain.state_dict().items():
            if n not in names:
                out[n] = v
        return out

    def set_state_dict(self, state_dict, *a, **k):
        plain = self._plain[0]
        names = {n for n, _ in plain.named_parameters()}
        missing = sorted(names - set(state_dict))
        if missing:
            raise KeyError(f"set_state_dict: no value for {missing}")
        self.sharder.load_full_state(state_dict)
        rest = {n: v for n, v in state_dict.items() if n not in names}
        if rest:
            with torch.no_grad():
                for n, b in plain.named_buffers():
                    if n in rest:
                        b.copy_(torch.as_tensor(rest[n]))
        return [], []

    load_state_dict = set_state_dict


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """reference distributed/sharding/group_sharded.py: (model, optimizer,
    scaler) by `level`: "os" (optimizer state sharded), "os_g" (and the
    gradients), "p_g_os" (and the parameters). Each rank trains on its own
    rows; the optimizer averages the gradients over the group (and
    `dp_group`)."""
    if level in ("os", "os_g"):
        opt = GroupShardedOptimizerStage2(list(optimizer._params), optimizer,
                                          group, offload=offload,
                                          dp_group=dp_group)
        mdl = (GroupShardedStage2(model, opt, group,
                                  sync_buffers=sync_buffers,
                                  buffer_max_size=buffer_max_size,
                                  dp_group=dp_group)
               if level == "os_g" else model)
        return mdl, opt, scaler
    if level == "p_g_os":
        mdl = GroupShardedStage3(model, optimizer, group,
                                 sync_buffers=sync_buffers,
                                 segment_size=segment_size, offload=offload,
                                 sync_comm=sync_comm, dp_group=dp_group,
                                 exclude_layer=exclude_layer)
        opt = GroupShardedOptimizerStage2(list(optimizer._params), optimizer,
                                          group, offload=offload,
                                          dp_group=dp_group)
        return mdl, opt, scaler
    raise ValueError(f"unknown group_sharded level {level}")
