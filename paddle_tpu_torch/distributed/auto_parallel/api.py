"""The semi-automatic parallel API (``paddle_tpu.distributed.auto_parallel.
api`` counterpart): placements, ``ProcessMesh``, ``shard_tensor``,
``reshard``, ``shard_layer``, ``shard_optimizer``, ``shard_dataloader``
and ``DistModel``/``to_static``.

The JAX package holds one global value per tensor and lets GSPMD place
it. The port runs a process per rank, so a DistTensor is the port's
``Tensor`` holding THIS rank's shard, with ``_placements``,
``_process_mesh`` and ``_global_shape`` recorded; what the ranks of a
mesh hold, assembled by their coordinates (``unshard_dtensor``), is the
JAX package's global value.

* ``Shard(d)`` on mesh dim i cuts tensor dim d into contiguous blocks in
  the order of the coordinates along i (several mesh dims on one tensor
  dim: the lower mesh dim is the major one, as a ``PartitionSpec`` tuple
  is); ``Replicate()`` keeps the whole value.
* ``Partial(reduce_type)``: the local value is a partial result, and
  the global value is the ranks' reduction along that mesh dim. The rule
  for a Partial built from a global value (``shard_tensor`` or ``reshard``
  from Replicate/Shard): for "sum" the rank at coordinate 0 of the dim
  holds the value and the others zeros; for "max", "min" and "avg" every
  rank holds it. So the global value stays the one given, as in the JAX
  package, whose Partial is a no-op under its global view.
  ``dtensor_from_local`` takes local partial values as they are.
* ``reshard`` runs the collective the two placements call for, mesh dim
  by mesh dim: s->r all-gather, r->s a local slice, p->r all-reduce,
  p->s reduce-scatter, s(i)->s(j) all-to-all; a transition those cannot
  express (a tensor dim sharded by a later mesh dim as well, another
  mesh) gathers the global value and slices it.
* Gradients follow the placements: the gradient of a Shard value is this
  rank's block of the global gradient, and that of a Replicate or a
  Partial value the whole global gradient on every rank (a loss that
  every rank computes alike, as a replicated value's is). So each
  transition's backward is the transition of the gradient back, with
  Partial read as Replicate: s->r slices it, r->s and p->s all-gather it,
  p->r and r->p pass it as it is, s(i)->s(j) all-to-alls it back, and
  ``shard_tensor``'s backward gathers it into the global gradient. Every
  rank of the mesh runs the backward, as it ran the forward. The
  collectives run through autograd only when the value needs a gradient.

``ProcessMesh`` makes its process groups (one per dim, and one over all
its ranks) when it is built, on every rank, as c10d asks; a mesh of the
same ids and names reuses them, and a dim whose name is an axis of the
global rank mesh (``distributed.mesh``) over the same ranks uses that
mesh's group.

``DistModel`` is the port's ``TrainStep(mesh=, zero_axis=)``, taking a
``torch.nn.Module`` or a Paddle-API ``Layer``. With ``mesh=`` the step
takes the GLOBAL batch and cuts each data rank's rows; a batch from a
loader that ``shard_dataloader`` already cut (``to_static``'s `loader`)
is taken as this rank's rows. Eval and predict run the network's forward
on every rank (its tensor-parallel collectives need every mp rank); a
LLaMA under mp gathers its vocabulary shards, so predict returns the
full-vocabulary logits on every rank.
"""
from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
           "shard_tensor", "dtensor_from_fn", "dtensor_from_local",
           "unshard_dtensor", "reshard", "shard_layer", "shard_optimizer",
           "shard_dataloader", "to_static", "get_placements", "DistModel"]


class Placement:
    pass


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def is_replicated(self):
        return False

    def is_partial(self):
        return False

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, o):
        return isinstance(o, Shard) and o.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))


class Replicate(Placement):
    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return True

    def is_partial(self):
        return False

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, o):
        return isinstance(o, Replicate)

    def __hash__(self):
        return hash("replicate")


class Partial(Placement):
    """A pending reduction: the local value is a partial result (see the
    module's docstring for the values a Partial built from a global value
    holds)."""

    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return False

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, o):
        return isinstance(o, Partial) and o.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))


# (shape, ids, dim names) -> {dim index or "all": Group}: c10d makes every
# rank create each group, so a mesh built again reuses its groups
_MESH_GROUPS: dict = {}


def _world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ProcessMesh:
    """A grid of global ranks with named dims (JAX default names ``d0``,
    ``d1``, ...), and its process groups."""

    def __init__(self, mesh, dim_names=None, shape=None, process_ids=None):
        arr = np.asarray(mesh)
        self._shape = list(arr.shape)
        self._ids = arr.reshape(-1).tolist()
        self._dim_names = (list(dim_names) if dim_names
                           else [f"d{i}" for i in range(arr.ndim)])
        self._grid = arr
        self._groups = self._build_groups()

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def process_ids(self):
        return self._ids

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def _dim(self, dim) -> int:
        return self._dim_names.index(dim) if isinstance(dim, str) \
            else int(dim)

    def _lines(self, dim: int):
        """The rank lists along mesh dim `dim`, each in coordinate
        order."""
        moved = np.moveaxis(self._grid, dim, -1)
        return [list(map(int, row))
                for row in moved.reshape(-1, self._shape[dim])]

    def _build_groups(self) -> dict:
        world, me = _world()
        if world == 1 or max(self._ids) >= world:
            return {}
        from paddle_tpu_torch.distributed.collective import _GROUPS, new_group
        from paddle_tpu_torch.distributed.mesh import get_mesh

        key = (tuple(self._shape), tuple(self._ids), tuple(self._dim_names))
        cached = _MESH_GROUPS.get(key)
        # groups of a process group since destroyed are not reused
        if cached is not None and all(g.id in _GROUPS
                                      for g in cached.values()):
            return cached
        glob = get_mesh()
        groups = {}
        for i, name in enumerate(self._dim_names):
            lines = self._lines(i)
            if self._shape[i] == 1:
                continue
            if glob is not None and name in glob.shape and \
                    sorted(map(sorted, glob._comm_lists((name,)))) == \
                    sorted(map(sorted, lines)):
                groups[i] = glob.group(name)
                continue
            for line in lines:
                g = new_group(line, name=f"process_mesh.{name}")
                if me in line:
                    groups[i] = g
        if len(self._ids) > 1:
            g = new_group(sorted(self._ids), name="process_mesh.all")
            if me in self._ids:
                groups["all"] = g
        _MESH_GROUPS[key] = groups
        return groups

    def get_group(self, dim_name=None):
        """This rank's group along `dim_name` (all the mesh's ranks when
        None); None in a world of one or on a dim of size 1."""
        return self._groups.get("all" if dim_name is None
                                else self._dim(dim_name))

    def coord(self, rank=None) -> list:
        """`rank`'s (this rank's) coordinates in the grid."""
        r = _world()[1] if rank is None else int(rank)
        hit = np.argwhere(self._grid == r)
        if not len(hit):
            raise ValueError(f"rank {r} is not in {self}")
        return [int(i) for i in hit[0]]

    def __eq__(self, o):
        return (isinstance(o, ProcessMesh) and o._shape == self._shape
                and o._ids == self._ids)

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._ids)))

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dim_names={self._dim_names})"


def get_placements(tensor):
    return getattr(tensor, "_placements", None)


# ---------------------------------------------------------------------------
# local <-> global

def _torch(x):
    """A torch tensor of `x` (a Tensor, torch tensor or array)."""
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    from paddle_tpu_torch.core.tensor import _from_numpy

    return _from_numpy(np.asarray(x))


def _sharders(placements, d) -> list:
    return [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == d]


def _block(placements, mesh, coord, d):
    """(block index, block count) of tensor dim d at `coord`."""
    idx, n = 0, 1
    for i in _sharders(placements, d):
        idx = idx * mesh.shape[i] + coord[i]
        n *= mesh.shape[i]
    return idx, n


def _slice_dim(v, d, idx, n):
    if v.shape[d] % n:
        raise ValueError(f"dim {d} of size {v.shape[d]} does not split "
                         f"into {n} shards")
    k = v.shape[d] // n
    return v.narrow(d, idx * k, k)


def _partial_fill(v, placements, coord):
    """A global value's local part under its Partial dims: for "sum" zeros
    off coordinate 0 of each such dim."""
    for i, p in enumerate(placements):
        if isinstance(p, Partial) and p.reduce_type == "sum" and coord[i]:
            return torch.zeros_like(v)
    return v


def _from_global(v, mesh, placements, coord=None):
    coord = mesh.coord() if coord is None else coord
    for d in range(v.dim()):
        idx, n = _block(placements, mesh, coord, d)
        if n > 1:
            v = _slice_dim(v, d, idx, n)
    return _partial_fill(v, placements, coord)


def _order(group, line):
    """Positions, in the group's member order (sorted ranks), of the
    ranks of `line` (coordinate order)."""
    return [group.ranks.index(r) for r in line]


def _my_line(mesh, i):
    """The ranks along mesh dim i through this rank, in coordinate
    order."""
    me = _world()[1]
    for line in mesh._lines(i):
        if me in line:
            return line
    raise ValueError(f"rank {me} is not in {mesh}")


def _to_global(local, mesh, placements):
    """The global value from every rank's local part: an all-gather over
    the mesh's ranks, assembled by coordinates (the Partial dims reduced
    by their reduce type)."""
    from paddle_tpu_torch.distributed import collective

    g = mesh.get_group()
    if g is None:
        parts = {tuple(mesh.coord()): local.detach()}
    else:
        outs = collective.all_gather(None, local.detach().contiguous(), g)
        parts = {tuple(mesh.coord(r)): outs[g.ranks.index(r)]
                 for r in mesh.process_ids}
    partial = [i for i, p in enumerate(placements) if isinstance(p, Partial)]
    kinds = {placements[i].reduce_type for i in partial}
    if len(kinds) > 1:
        raise NotImplementedError(f"Partial dims of different reduce types "
                                  f"{sorted(kinds)}")
    kind = kinds.pop() if kinds else "sum"
    reduced: dict = {}
    for c, v in parts.items():
        key = tuple(0 if i in partial else x for i, x in enumerate(c))
        acc = reduced.get(key)
        if acc is None:
            reduced[key] = v.clone()
        elif kind in ("sum", "avg"):
            acc += v
        elif kind == "max":
            torch.maximum(acc, v, out=acc)
        else:
            torch.minimum(acc, v, out=acc)
    if kind == "avg":
        n = int(np.prod([mesh.shape[i] for i in partial]))
        for v in reduced.values():
            v /= n
    shape = list(local.shape)
    for d in range(local.dim()):
        shape[d] *= _block(placements, mesh, [0] * mesh.ndim, d)[1]
    out = torch.empty(shape, dtype=local.dtype, device=local.device)
    for c, v in reduced.items():
        view = out
        for d in range(local.dim()):
            idx, n = _block(placements, mesh, list(c), d)
            if n > 1:
                view = _slice_dim(view, d, idx, n)
        view.copy_(v)
    return out


def _grad_placements(placements) -> list:
    """The placements of the gradient of a value placed so: a Partial
    value's gradient is the whole one on every rank."""
    return [Replicate() if isinstance(p, Partial) else p for p in placements]


def _tracked(v) -> bool:
    return torch.is_grad_enabled() and v.requires_grad


def _own(out, inp):
    """`out`, copied when it is `inp` or a view (an autograd Function's
    output may not alias its input)."""
    return out.clone() if out is inp or out._is_view() else out


class _FromGlobal(torch.autograd.Function):
    """A global value -> this rank's part; backward assembles the
    gradient's parts into the global gradient."""

    @staticmethod
    def forward(ctx, full, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return _own(_from_global(full, mesh, placements), full)

    @staticmethod
    def backward(ctx, g):
        return (_to_global(g.contiguous(), ctx.mesh,
                           _grad_placements(ctx.placements)), None, None)


class _ToGlobal(torch.autograd.Function):
    """This rank's part -> the global value; backward takes this rank's
    part of the global gradient."""

    @staticmethod
    def forward(ctx, local, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return _to_global(local, mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return (_from_global(g, ctx.mesh, _grad_placements(ctx.placements))
                .contiguous(), None, None)


def _scatter(full, mesh, placements):
    """``_from_global``, carrying the gradient when `full` needs one."""
    if _tracked(full):
        return _FromGlobal.apply(full, mesh, list(placements))
    return _from_global(full, mesh, placements)


def _gather(local, mesh, placements):
    """``_to_global``, carrying the gradient when `local` needs one."""
    if _tracked(local):
        return _ToGlobal.apply(local, mesh, list(placements))
    return _to_global(local, mesh, placements)


def _dist(local, mesh, placements, global_shape, like=None):
    """A DistTensor over `local`: a float value's stop_gradient is its
    own (it carries the graph), an integer one's is `like`'s."""
    out = Tensor(local)
    if like is not None and not (local.dtype.is_floating_point
                                 or local.dtype.is_complex):
        out.stop_gradient = getattr(like, "stop_gradient", True)
    out._placements = list(placements)
    out._process_mesh = mesh
    out._global_shape = list(global_shape)
    return out


def _check(mesh, placements):
    if len(placements) != mesh.ndim:
        raise ValueError(f"{len(placements)} placements for a {mesh.ndim}-d "
                         f"mesh")


def shard_tensor(data, mesh: ProcessMesh, placements, dtype=None,
                 place=None, stop_gradient=None):
    """A DistTensor of the global value `data`: this rank's shard (see
    the module's docstring), linked to `data` in the autograd graph."""
    _check(mesh, placements)
    src = data if isinstance(data, Tensor) else None
    v = _torch(data)
    if dtype is not None:
        from paddle_tpu_torch.core.dtype import to_torch_dtype

        v = v.to(to_torch_dtype(dtype))
    if place is not None:
        from paddle_tpu_torch.core.device import current_device

        v = v.to(current_device(place))
    local = _scatter(v, mesh, placements)
    out = _dist(local, mesh, placements, v.shape, like=src)
    if stop_gradient is not None:
        out.stop_gradient = stop_gradient
    return out


def dtensor_from_fn(fn: Callable, mesh: ProcessMesh, placements, *args,
                    **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def dtensor_from_local(local, mesh: ProcessMesh, placements):
    """A DistTensor whose local part is `local` as it is (a Partial's
    partial value, or an already cut shard)."""
    _check(mesh, placements)
    v = _torch(local)
    shape = list(v.shape)
    for d in range(v.dim()):
        shape[d] *= _block(placements, mesh, [0] * mesh.ndim, d)[1]
    return _dist(v, mesh, placements, shape,
                 like=local if isinstance(local, Tensor) else None)


def unshard_dtensor(dist_tensor) -> Tensor:
    """The global value of a DistTensor (a ``Tensor``, or a torch
    parameter that ``shard_layer`` marked), on every rank of its mesh."""
    return Tensor(_gather(_torch(dist_tensor), dist_tensor._process_mesh,
                          dist_tensor._placements))


def _later_sharders_ok(cur, i, dims) -> bool:
    """The collective of mesh dim i applies when no LATER mesh dim shards
    one of the tensor dims it touches (the earlier ones are the major
    blocks, so dim i's blocks stay contiguous inside them)."""
    return all(j <= i for d in dims for j in _sharders(cur, d) if j != i)


def _split(local, d, n, order):
    """`local`'s n blocks of dim `d`, listed in the group's member
    order."""
    if local.shape[d] % n:
        raise ValueError(f"dim {d} of size {local.shape[d]} does not split "
                         f"into {n} shards")
    send = [None] * n
    for pos, blk in zip(order, local.chunk(n, d)):
        send[pos] = blk.contiguous()
    return send


def _reshard_dim(local, mesh, i, s, d):
    """This rank's part after mesh dim i moves from placement s to d, by
    the collective over that dim's group."""
    from paddle_tpu_torch.distributed import collective

    if s == d:
        return local
    g = mesh.get_group(mesh.dim_names[i])
    line = _my_line(mesh, i)
    n, c = mesh.shape[i], line.index(_world()[1])
    order = _order(g, line)
    if isinstance(s, Partial):
        if isinstance(d, Shard) and s.reduce_type == "sum":
            send = _split(local, d.dim, n, order)
            out = torch.empty_like(send[0])
            collective.reduce_scatter(out, send, group=g)
            return out
        # reduce, then as from Replicate
        local = local.clone()
        collective.all_reduce(local, s.reduce_type, g)
        s = Replicate()
    if isinstance(s, Shard) and isinstance(d, Shard):
        recv: list = []
        collective.all_to_all(recv, _split(local, d.dim, n, order), group=g)
        return torch.cat([recv[p] for p in order], s.dim)
    if isinstance(d, Shard):                         # r -> s
        return _slice_dim(local, d.dim, c, n)
    if isinstance(s, Shard):                         # s -> r/p
        outs = collective.all_gather(None, local.contiguous(), g)
        local = torch.cat([outs[p] for p in order], s.dim)
    if isinstance(d, Partial) and d.reduce_type == "sum" and c:
        local = torch.zeros_like(local)              # r/s -> p(sum)
    return local


class _ReshardDim(torch.autograd.Function):
    """``_reshard_dim``; backward moves the gradient back, Partial read
    as Replicate (the module's docstring)."""

    @staticmethod
    def forward(ctx, local, mesh, i, s, d):
        ctx.args = (mesh, i, s, d)
        return _own(_reshard_dim(local, mesh, i, s, d), local)

    @staticmethod
    def backward(ctx, g):
        mesh, i, s, d = ctx.args
        gs, gd = _grad_placements([d, s])
        return (_reshard_dim(g.contiguous(), mesh, i, gs, gd).contiguous(),
                None, None, None, None)


def reshard(dist_tensor, mesh: ProcessMesh, placements):
    """Move a DistTensor to `placements` (see the module's docstring)."""
    _check(mesh, placements)
    src_mesh = getattr(dist_tensor, "_process_mesh", None)
    src = getattr(dist_tensor, "_placements", None)
    local = _torch(dist_tensor)
    if src is None:
        # a plain tensor: a global value, replicated
        return shard_tensor(dist_tensor, mesh, placements)
    gshape = getattr(dist_tensor, "_global_shape", None) or list(local.shape)
    if src_mesh != mesh:
        full = _gather(local, src_mesh, src)
        return _dist(_scatter(full, mesh, placements), mesh, placements,
                     gshape, like=dist_tensor)
    cur = list(src)
    for i, (s, d) in enumerate(zip(src, placements)):
        if s == d:
            continue
        dims = [p.dim for p in (s, d) if isinstance(p, Shard)]
        if mesh.get_group(mesh.dim_names[i]) is None or \
                not _later_sharders_ok(cur, i, dims):
            full = _gather(local, mesh, cur)
            cur[i] = d
            local = _scatter(full, mesh, cur)
            continue
        local = (_ReshardDim.apply(local, mesh, i, s, d) if _tracked(local)
                 else _reshard_dim(local, mesh, i, s, d))
        cur[i] = d
    return _dist(local, mesh, placements, gshape, like=dist_tensor)


# ---------------------------------------------------------------------------
# layers, optimizers, loaders

def _is_paddle_layer(layer) -> bool:
    from paddle_tpu_torch.nn.layer.layers import Layer

    return isinstance(layer, Layer)


def _mp_dim(mesh):
    """(the mesh dim along which this rank's line is the tensor-parallel
    group in mp rank order, its size), or None without tensor
    parallelism."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import (
        mp_group)

    g = mp_group()
    if g is None or g.nranks == 1:
        return None
    for i in range(mesh.ndim):
        if _my_line(mesh, i) == list(g.ranks):
            return i, g.nranks
    raise ValueError(f"{mesh} has no dim over the tensor-parallel group "
                     f"{list(g.ranks)}, so it cannot place the mp-sharded "
                     f"parameters")


def _replicate_params(name, sublayer, mesh):
    """The default ``shard_fn``: every parameter replicated, but for an
    mp shard of the tensor-parallel layers (``mp_sharded``), which is
    ``Shard(split_axis)`` along the mesh dim over the mp group (marked
    with its placements, mesh and global shape; the value stays where it
    is)."""
    mp = None
    for pname, p in list(sublayer._parameters.items()):
        if p is None:
            continue
        placements = [Replicate()] * mesh.ndim
        shape = list(p.shape)
        if getattr(p, "mp_sharded", False) is True:
            mp = mp or _mp_dim(mesh)
            if mp is not None:
                ax = int(getattr(p, "split_axis", 0))
                placements[mp[0]] = Shard(ax)
                shape[ax] *= mp[1]
        p._placements = placements
        p._process_mesh = mesh
        p._global_shape = shape


def shard_layer(layer, process_mesh: ProcessMesh,
                shard_fn: Callable | None = None,
                input_fn: Callable | None = None,
                output_fn: Callable | None = None):
    """Call ``shard_fn(name, sublayer, mesh)`` on every sublayer (the
    default replicates each parameter); ``input_fn(inputs, mesh)`` and
    ``output_fn(outputs, mesh)`` become forward pre- and post-hooks. A
    Paddle-API ``Layer`` and a ``torch.nn.Module`` each take their own
    hook API."""
    shard_fn = shard_fn or _replicate_params
    paddle = _is_paddle_layer(layer)
    named = (layer.named_sublayers(include_self=True) if paddle
             else layer.named_modules())
    for name, sub in list(named):
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda l, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        post = (layer.register_forward_post_hook if paddle
                else layer.register_forward_hook)
        post(lambda l, inp, out: output_fn(out, process_mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None):
    """ZeRO over the rank mesh: ``fleet.sharding_stages``'
    ``ShardOptimizerWrapper`` (``ShardingStage1/2/3`` as `shard_fn`)."""
    from paddle_tpu_torch.distributed.fleet.sharding_stages import (
        ShardOptimizerWrapper)

    return ShardOptimizerWrapper(optimizer, shard_fn)


class _ShardedLoader:
    """This rank's rows of each batch, along the data-parallel dims only:
    model-parallel peers (the same dp position) read the same rows. Nested
    tuple/list/dict batches are sliced recursively; a tail that does not
    divide pads by wrapping around, so no row is dropped."""

    def __init__(self, loader, shard_index: int, num_shards: int):
        self._loader = loader
        self._idx = shard_index
        self._n = num_shards

    def _slice(self, item):
        if isinstance(item, dict):
            return {k: self._slice(v) for k, v in item.items()}
        if isinstance(item, (tuple, list)):
            return type(item)(self._slice(v) for v in item)
        v = item._value if isinstance(item, Tensor) else item
        if not hasattr(v, "shape") or not len(v.shape):
            return item
        n = v.shape[0]
        per = -(-n // self._n)  # ceil: wrap-around pad, never drop rows
        if n % self._n:
            rows = np.arange(self._idx * per, (self._idx + 1) * per) % n
            sl = v[torch.from_numpy(rows).to(v.device)] \
                if isinstance(v, torch.Tensor) else v[rows]
        else:
            sl = v[self._idx * per:(self._idx + 1) * per]
        return Tensor(sl) if isinstance(item, Tensor) else sl

    def __iter__(self):
        for batch in self._loader:
            yield self._slice(batch)

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, name):
        return getattr(self.__dict__["_loader"], name)


def _dp_shard_position(shard_dims=None, meshes=None):
    """(shard_index, num_shards) of THIS rank along the data-parallel dims
    of the global rank mesh (default its dp and sharding axes above 1),
    or of `meshes` (a ``ProcessMesh``) when there is none; mp/pp peers
    share a position. None when there is no such dim."""
    from paddle_tpu_torch.distributed.env import get_rank
    from paddle_tpu_torch.distributed.mesh import get_mesh

    mesh = get_mesh()
    if mesh is None:
        pm = meshes[0] if isinstance(meshes, (list, tuple)) else meshes
        if not isinstance(pm, ProcessMesh) or shard_dims is None:
            return None
        dims = (shard_dims,) if isinstance(shard_dims, (str, int)) \
            else tuple(shard_dims)
        dims = [pm._dim(d) for d in dims]
        coord = pm.coord()
        pos, num = 0, 1
        for i in dims:
            pos, num = pos * pm.shape[i] + coord[i], num * pm.shape[i]
        return (pos, num) if num > 1 else None
    if shard_dims is None:
        dims = tuple(a for a in ("dp", "sharding")
                     if mesh.shape.get(a, 1) > 1)
    else:
        dims = ((shard_dims,) if isinstance(shard_dims, str)
                else tuple(shard_dims))
        dims = tuple(a for a in dims if mesh.shape.get(a, 1) > 1)
    if not dims:
        return None
    ranks = mesh.axis_ranks(dims)
    num = int(np.prod([mesh.shape[a] for a in dims]))
    return ranks.index(get_rank()), num


def shard_dataloader(dataloader, meshes, shard_dims=None,
                     is_dataset_splitted=False, dense_tensor_idx=None):
    """Feed each rank its rows: the loader's batches cut to this rank's
    data-parallel block (``_ShardedLoader``). A world of one, a dataset
    already split, or a rank with no data-parallel position gets the
    loader unchanged."""
    from paddle_tpu_torch.distributed.env import get_world_size

    if is_dataset_splitted or get_world_size() == 1:
        return dataloader
    pos = _dp_shard_position(shard_dims, meshes)
    if pos is None:
        return dataloader
    return _ShardedLoader(dataloader, *pos)


# ---------------------------------------------------------------------------
# DistModel

def _rank_mesh_of(pm: ProcessMesh):
    """The global rank mesh of a ProcessMesh whose dims are mesh axes over
    the whole world in rank order, built and installed (``build_mesh``:
    the step's hcg then reuses its groups); else None (its dims name no
    parallelism the step knows: the ranks train replicated)."""
    from paddle_tpu_torch.distributed.mesh import AXIS_ORDER, build_mesh

    world, _ = _world()
    if set(pm.dim_names) - set(AXIS_ORDER) or pm.process_ids != \
            list(range(world)):
        return None
    axes = dict(zip(pm.dim_names, pm.shape))
    if [a for a in AXIS_ORDER if a in axes] != list(pm.dim_names):
        return None
    return build_mesh(axes)


def _to_device(x, device):
    if isinstance(x, Tensor):
        x = x._value
    if isinstance(x, np.ndarray):
        from paddle_tpu_torch.core.tensor import _from_numpy

        x = _from_numpy(x)
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return x


class DistModel:
    """The network, loss and optimizer as one training step over the rank
    mesh (``TrainStep(mesh=, zero_axis=)``), with train/eval/predict
    modes. The mesh is the global rank mesh, else the first parameter's
    ``_process_mesh`` (``shard_tensor``/``shard_layer``) when its dims
    are mesh axes; ``strategy.hybrid_configs["sharding_degree"] > 1``
    shards the optimizer state over the mesh's "sharding", else "dp",
    axis (a warning when it has neither)."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None):
        from paddle_tpu_torch.distributed.mesh import get_mesh
        from paddle_tpu_torch.parallel.train_step import PaddleLayerModule

        self.network = layer
        # the torch view of the network, which every mode calls
        self._module = (PaddleLayerModule(layer) if _is_paddle_layer(layer)
                        else layer)
        self._loss = loss
        self._optimizer = optimizer
        # a loader shard_dataloader cut feeds this rank's rows
        self._local_batches = isinstance(loader, _ShardedLoader)
        mesh = get_mesh()
        if mesh is None:
            for p in layer.parameters():
                pm = getattr(p, "_process_mesh", None)
                if pm is not None:
                    mesh = _rank_mesh_of(pm)
                    break
        self._mesh = mesh
        zero_axis = None
        hc = (getattr(strategy, "hybrid_configs", None)
              if strategy is not None else None)
        if hc and int(hc.get("sharding_degree", 1)) > 1:
            shape = dict(mesh.shape) if mesh is not None else {}
            # honour the request on whatever data axis the mesh has: a
            # silent no-op would replicate state the user asked to shard
            for ax in ("sharding", "dp"):
                if shape.get(ax, 1) > 1:
                    zero_axis = ax
                    break
            if zero_axis is None:
                warnings.warn(
                    "strategy requests sharding_degree > 1 but the mesh has "
                    "no 'sharding'/'dp' axis larger than 1; optimizer state "
                    "stays replicated")
        self._zero_axis = zero_axis
        self._step = None
        # set before the first step to keep its metrics (last_metrics())
        self.collect_metrics = False
        self._mode = ("train" if (loss is not None and optimizer is not None)
                      else "eval" if loss is not None else "predict")

    # -- modes ----------------------------------------------------------------
    def train(self):
        if self._loss is None or self._optimizer is None:
            raise RuntimeError("DistModel.train() requires loss and optimizer")
        self._mode = "train"
        return self

    def eval(self):
        if self._loss is None:
            raise RuntimeError("DistModel.eval() requires a loss")
        self._mode = "eval"
        return self

    def predict(self):
        self._mode = "predict"
        return self

    # -- steps ----------------------------------------------------------------
    def _train_impl(self, *batch):
        if self._step is None:
            from paddle_tpu_torch.parallel.train_step import TrainStep

            loss = self._loss
            self._step = TrainStep(
                self._module, lambda out, lab: loss(out, lab),
                self._optimizer, mesh=self._mesh, zero_axis=self._zero_axis,
                local_batch=self._local_batches,
                collect_metrics=self.collect_metrics,
                # Model.fit(resilience=) parks its AnomalyDetector here so
                # the lazily built step carries the health check
                anomaly_detector=getattr(self, "_anomaly", None))
            pending = getattr(self, "_pending_resume", None)
            if pending is not None:
                # a checkpoint restored before this lazy build left its
                # per-step extras for the step just built
                self._step.load_resume_extras(*pending)
                self._pending_resume = None
        if len(batch) == 1 and isinstance(batch[0], dict):
            batch = ({k: v._value if isinstance(v, Tensor) else v
                      for k, v in batch[0].items()},)
        else:
            batch = tuple(b._value if isinstance(b, Tensor) else b
                          for b in batch)
        return Tensor(self._step(*batch))

    def _sync(self):
        """The port's step updates the network's parameters and the
        optimizer's state in place: nothing to copy back."""

    def __call__(self, *args):
        from paddle_tpu_torch.parallel.segments import sep_execution
        from paddle_tpu_torch.parallel.train_step import PaddleLayerModule

        if self._mode == "train":
            return self._train_impl(*args)
        dev = next(self._module.parameters()).device
        named = len(args) == 1 and isinstance(args[0], dict)
        if named:
            kw = {k: _to_device(v, dev) for k, v in args[0].items()}
        else:
            args = [_to_device(a, dev) for a in args]
        with torch.no_grad(), sep_execution(None):
            if self._mode == "eval":
                # a dict batch gives the network its labels, as the step
                if named:
                    out, label = self._module(**kw), kw["labels"]
                else:
                    out, label = self._module(*args[:-1]), args[-1]
                if isinstance(self._module, PaddleLayerModule):
                    label = PaddleLayerModule.tensor(label)
                loss = self._loss(out, label)
                return loss if isinstance(loss, Tensor) else Tensor(loss)
            if named:
                kw.pop("labels", None)
            out = self._module(**kw) if named else self._module(*args)
        return out if isinstance(out, Tensor) else Tensor(out)

    def state_dict(self, *a, **k):
        return self.network.state_dict(*a, **k)

    def set_state_dict(self, state):
        """Copy `state` (Tensors, torch tensors or arrays) into the
        network's tensors in place: a step already built trains on from
        it. Returns (missing names, unexpected names); a shape mismatch
        raises."""
        own = self.network.state_dict()
        with torch.no_grad():
            for name, v in state.items():
                if name not in own:
                    continue
                dst, src = _torch(own[name]), _torch(v)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"shape mismatch for '{name}': "
                                     f"{tuple(src.shape)} vs "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src.to(dst.device))
        missing = [n for n in own if n not in state]
        unexpected = [n for n in state if n not in own]
        return missing, unexpected

    def parameters(self):
        return self.network.parameters()

    def last_metrics(self):
        """The last training step's metrics (``TrainStep.last_metrics``:
        loss, the global gradient norm, ...), with ``collect_metrics``
        set before the first step; else None."""
        return None if self._step is None else self._step.last_metrics()

    def dist_main_program(self, mode=None):
        return self._step

    @property
    def mode(self):
        return self._mode


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None):
    """The DistModel of the network, loss and optimizer (the port's
    training step over the mesh); `loader`, when ``shard_dataloader`` cut
    it, marks the batches as this rank's rows."""
    return DistModel(layer, loader, loss, optimizer, strategy)
