"""The global rank mesh (``paddle_tpu.distributed.mesh`` counterpart).

The JAX package's mesh is one ``jax.sharding.Mesh`` over the devices of
one SPMD program, its axes named after the parallelisms. The port runs a
process per rank, so its mesh is a grid of global ranks with the same
axis names in the same order (``AXIS_ORDER``, the reference topology's
order, pp outermost, mp innermost): rank r sits where device r sits in
the JAX mesh of the same axes. Each axis names process groups: the ranks
that differ from this rank only along that axis (``group(axis)``), or
along several axes at once (``group(("dp", "sharding"))``, the fused
group for gradient averaging). An "ep" axis (expert parallelism) is a
data axis of the MoE layers: it follows ``AXIS_ORDER``, as in the JAX
mesh, and its fused groups with dp and sharding are the ranks that hold
different rows. A "sep" axis (sequence parallelism) splits the
sequence: its fused groups with dp and sharding are the ranks whose
gradients are summed (``fused_allreduce_gradients``). ``build_mesh``
creates every such group on every rank,
as c10d requires; an axis of size 1 needs no process group.
"""
from __future__ import annotations

from itertools import product
from typing import Mapping

import numpy as np

from paddle_tpu_torch.distributed.collective import Group, new_group
from paddle_tpu_torch.distributed.env import get_rank, get_world_size

__all__ = ["AXIS_ORDER", "RankMesh", "build_mesh", "get_mesh", "set_mesh",
           "mesh_axis_size"]

AXIS_ORDER = ("pp", "dp", "sharding", "sep", "mp")
# fused groups: the data ranks (dp x sharding), with an expert axis the
# ranks holding different rows (dp, sharding and ep), with a sep axis the
# ranks holding different rows or different segments of them
FUSED = (("dp", "sharding"), ("dp", "ep"), ("sharding", "ep"),
         ("dp", "sharding", "ep"), ("dp", "sep"), ("sharding", "sep"),
         ("dp", "sharding", "sep"))

_GLOBAL_MESH: list = [None]


class RankMesh:
    """A grid of global ranks with named axes and their process groups."""

    def __init__(self, axes: Mapping[str, int]):
        names = ([a for a in AXIS_ORDER if a in axes]
                 + [a for a in axes if a not in AXIS_ORDER])
        self.axis_names = tuple(names)
        self.shape = {a: int(axes[a]) for a in names}
        total = int(np.prod(list(self.shape.values()))) if names else 1
        world = get_world_size()
        if total != world:
            raise ValueError(f"mesh axes {dict(axes)} hold {total} ranks; "
                             f"the world has {world}")
        self.ranks = np.arange(total).reshape(
            [self.shape[a] for a in names] or [1])
        self._groups: dict[tuple, Group] = {}
        for key in [(a,) for a in names] + [f for f in FUSED
                                            if all(a in self.shape
                                                   for a in f)]:
            self._groups[key] = self._make(key)

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coord(self, rank: int | None = None) -> dict:
        r = get_rank() if rank is None else int(rank)
        idx = np.unravel_index(r, self.ranks.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def axis_ranks(self, axes, rank: int | None = None) -> tuple:
        """The ranks sharing `rank`'s coordinates off `axes`, sweeping
        `axes` row-major."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        base = self.coord(rank)
        out = []
        for combo in product(*[range(self.shape.get(a, 1)) for a in axes]):
            c = dict(base)
            c.update({a: v for a, v in zip(axes, combo) if a in self.shape})
            out.append(int(self.ranks[tuple(c[a] for a in self.axis_names)]))
        return tuple(out)

    def _comm_lists(self, axes):
        others = [a for a in self.axis_names if a not in axes]
        lists = []
        for combo in product(*[range(self.shape[a]) for a in others]):
            fixed = dict(zip(others, combo))
            ranks = []
            for sweep in product(*[range(self.shape[a]) for a in axes]):
                c = dict(fixed)
                c.update(zip(axes, sweep))
                ranks.append(int(self.ranks[tuple(c[a]
                                                  for a in self.axis_names)]))
            lists.append(ranks)
        return lists

    def _make(self, axes) -> Group:
        me = get_rank()
        name = "x".join(axes)
        if int(np.prod([self.shape[a] for a in axes])) == 1:
            return Group(id=-1, ranks=(me,), pg=None, name=name)
        for key, g in self._groups.items():     # a fused group over one
            if g.nranks == int(np.prod([self.shape[a] for a in axes])) \
                    and set(key) <= set(axes):  # real axis is that axis
                return g
        mine = None
        for ranks in self._comm_lists(axes):
            g = new_group(ranks, name=name)
            if me in ranks:
                mine = g
        return mine

    def group(self, axes) -> Group:
        """This rank's group along `axes` (an axis name or a tuple of
        them); an axis the mesh lacks counts as size 1."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in key if a in self.shape)
        if not key or int(np.prod([self.shape[a] for a in key])) == 1:
            return Group(id=-1, ranks=(get_rank(),), pg=None,
                         name="x".join(key))
        if key not in self._groups:
            raise KeyError(f"the mesh built no group over {key}")
        return self._groups[key]

    def __repr__(self):
        return f"RankMesh({self.shape})"


def build_mesh(axes: Mapping[str, int] | None = None, devices=None):
    """Build and install the global mesh: ``{"dp": 2, "mp": 2, ...}``; the
    sizes multiply to the world size (all of it a data-parallel axis when
    `axes` is None). Every rank calls it."""
    if axes is None:
        axes = {"dp": get_world_size()}
    mesh = RankMesh(axes)
    set_mesh(mesh)
    return mesh


def set_mesh(mesh):
    _GLOBAL_MESH[0] = mesh


def get_mesh():
    return _GLOBAL_MESH[0]


def mesh_axis_size(axis: str) -> int:
    m = get_mesh()
    if m is None or axis not in m.shape:
        return 1
    return int(m.shape[axis])
