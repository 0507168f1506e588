"""Hybrid-parallel topology (``paddle_tpu.distributed.fleet.topology``
counterpart; reference: fleet/base/topology.py:65 ``CommunicateTopology``,
:178 ``HybridCommunicateGroup``).

``CommunicateTopology`` is the N-D rank grid over ["pipe", "data",
"sharding", "sep", "model"], pure Python, its rank lists the JAX
package's. ``HybridCommunicateGroup`` holds this rank's coordinates and
one process group per axis, plus the fused data x sharding group, taken
from the port's rank mesh (``distributed.mesh``, built over the same
order, so rank r holds the coordinates of device r in the JAX mesh).
Every axis's group is built; the pipeline runs on the pp group
(``meta_parallel.PipelineParallel``, ``parallel.pipeline``), ring
attention on the sep group (``parallel.ring_attention``), and the
gradients of a sequence-parallel step are summed over the dp x sep
(x sharding) groups. An "expert" axis (``ep_degree`` >
1, innermost; the mesh's "ep") adds the expert-parallel group, whose
ranks hold different experts and different rows, and the
dp x sharding x ep group of the ranks holding different rows.
"""
from __future__ import annotations

from itertools import product

import numpy as np

from paddle_tpu_torch.distributed.env import get_rank
from paddle_tpu_torch.distributed.mesh import build_mesh, get_mesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "ParallelMode"]


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class CommunicateTopology:
    """reference: fleet/base/topology.py:65."""

    def __init__(self, hybrid_group_names=("pipe", "data", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = int(np.prod(self._dims))
        arr = np.arange(self._world).reshape(self._dims)
        self._rank_of_coord = arr
        self._coord_of_rank = {int(arr[c]): c for c in
                               product(*[range(d) for d in self._dims])}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return int(self._rank_of_coord[coord])

    def get_coord(self, rank):
        return self._coord_of_rank[rank]

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on `axis_name` equals index."""
        ax = self._parallel_names.index(axis_name)
        return sorted(int(self._rank_of_coord[c])
                      for c in product(*[range(d) for d in self._dims])
                      if c[ax] == index)

    def get_comm_list(self, axis_name):
        """The rank lists along `axis_name`, one a setting of the other
        axes (reference topology.py get_comm_list)."""
        ax = self._parallel_names.index(axis_name)
        other = [range(d) for i, d in enumerate(self._dims) if i != ax]
        groups = []
        for combo in product(*other):
            ranks = []
            for i in range(self._dims[ax]):
                coord = list(combo)
                coord.insert(ax, i)
                ranks.append(int(self._rank_of_coord[tuple(coord)]))
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return int(self._rank_of_coord[tuple(coord)])


# reference axis names -> the mesh's
_AXIS_TO_MESH = {"pipe": "pp", "data": "dp", "sharding": "sharding",
                 "sep": "sep", "model": "mp", "expert": "ep"}


class HybridCommunicateGroup:
    """reference: fleet/base/topology.py:178. The rank mesh is the global
    one when its axes have this topology's sizes, else a new one (built
    collectively)."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = get_rank()
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()
        self._dims = {n: topology.get_dim(n) for n in names}
        self._dp_degree = self._dims.get("data", 1)
        self._mp_degree = self._dims.get("model", 1)
        self._pp_degree = self._dims.get("pipe", 1)
        self._sharding_degree = self._dims.get("sharding", 1)
        self._sep_degree = self._dims.get("sep", 1)
        self._ep_degree = self._dims.get("expert", 1)
        want = {_AXIS_TO_MESH[n]: d for n, d in self._dims.items()}
        mesh = get_mesh()
        have = ({a: mesh.shape.get(a, 1) for a in want}
                if mesh is not None else None)
        if have != want or (mesh is not None and any(
                mesh.shape[a] > 1 for a in mesh.shape if a not in want)):
            mesh = build_mesh({a: d for a, d in want.items()})
        self.mesh = mesh
        self._coord = dict(zip(names, topology.get_coord(self.global_rank)))
        self._dp_group = mesh.group("dp")
        self._mp_group = mesh.group("mp")
        self._pp_group = mesh.group("pp")
        self._sharding_group = mesh.group("sharding")
        self._sep_group = mesh.group("sep")
        self._dp_sharding_group = mesh.group(("dp", "sharding"))
        self._ep_group = mesh.group("ep")
        self._dp_sharding_ep_group = mesh.group(("dp", "sharding", "ep"))
        self._dp_sep_group = mesh.group(("dp", "sep"))
        self._dp_sharding_sep_group = mesh.group(("dp", "sharding", "sep"))

    @classmethod
    def from_mesh(cls, mesh):
        """The hcg over a rank mesh's axes (missing axes of size 1)."""
        names = ["pipe", "data", "sharding", "sep", "model"]
        if mesh.shape.get("ep", 1) > 1:
            names.append("expert")
        topo = CommunicateTopology(
            names, [mesh.shape.get(_AXIS_TO_MESH[n], 1) for n in names])
        from paddle_tpu_torch.distributed.mesh import set_mesh

        set_mesh(mesh)
        return cls(topo)

    # ---- mode -------------------------------------------------------------
    def get_parallel_mode(self):
        """reference topology.py:285-322 mode selection."""
        if (self._mp_degree == 1 and self._pp_degree == 1
                and self._dp_degree == 1 and self._sharding_degree > 1):
            return ParallelMode.SHARDING_PARALLEL
        if self._mp_degree == 1 and self._pp_degree == 1:
            return ParallelMode.DATA_PARALLEL
        if self._mp_degree > 1 and self._pp_degree == 1:
            return ParallelMode.TENSOR_PARALLEL
        return ParallelMode.PIPELINE_PARALLEL

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # ---- data parallel ------------------------------------------------------
    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # ---- model (tensor) parallel --------------------------------------------
    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # ---- pipeline -----------------------------------------------------------
    def get_stage_id(self):
        return self._coord["pipe"]

    def get_pipe_parallel_rank(self):
        return self._coord["pipe"]

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return (self._pp_group,)

    # ---- sharding -----------------------------------------------------------
    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    # ---- sep ----------------------------------------------------------------
    def get_sep_parallel_rank(self):
        return self._coord.get("sep", 0)

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._sep_group

    # ---- expert parallel ----------------------------------------------------
    def get_expert_parallel_rank(self):
        return self._coord.get("expert", 0)

    def get_expert_parallel_world_size(self):
        return self._ep_degree

    def get_expert_parallel_group(self):
        return self._ep_group

    # ---- fused --------------------------------------------------------------
    def get_dp_sharding_parallel_group(self):
        return self._dp_sharding_group

    def get_dp_sharding_ep_parallel_group(self):
        """The ranks that hold different rows of a global batch: dp x
        sharding x ep, dp-major (the dp x sharding group without an
        expert axis)."""
        return self._dp_sharding_ep_group

    def get_dp_sep_parallel_group(self):
        """The ranks that hold different rows or different segments of
        them, dp x sep, dp-major: a replicated parameter's gradient is
        summed over it (reference topology.py ``get_dp_sep_parallel_group``)."""
        return self._dp_sep_group

    def get_dp_sharding_sep_parallel_group(self):
        """dp x sharding x sep, dp-major: every rank that shares no mp (or
        pp) coordinate."""
        return self._dp_sharding_sep_group

    def get_check_parallel_group(self, sharding=False):
        from paddle_tpu_torch.distributed.collective import get_group

        return get_group(0) if self.nranks > 1 else self._dp_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)
