"""Distributed training of the port (``paddle_tpu.distributed``
counterpart): one OS process per rank on ``torch.distributed``.

``init_parallel_env`` joins the process group of the launch contract
(rendezvous on the port's ``TCPStore``, ``store``); ``collective`` holds
the collectives over ``Group``s; ``mesh`` the rank grid with a process
group per axis; ``parallel.DataParallel`` and ``reducer`` the bucketed
gradient averaging; ``spawn`` starts ranks; ``utils`` the MoE dispatch
all-to-alls (``global_scatter``, ``global_gather``); ``fleet`` (import
it as ``paddle_tpu_torch.distributed.fleet``) is hybrid parallelism: the
topology, the tensor-parallel layers, ZeRO-1/2 and the hybrid optimizer.
The host plane: ``launch`` (``python -m
paddle_tpu_torch.distributed.launch``, the launcher), ``multiproc`` (host
collectives on the store and the rank-to-rank ``socket_plane``) and
``rpc``. Semi-automatic parallelism: ``auto_parallel`` (placements,
``ProcessMesh``, ``shard_tensor``/``reshard``, ``shard_layer``,
``shard_dataloader``, ``to_static``/``DistModel``, the ``Engine``) and
``auto_tuner``.
Also here: the fault-injection registry (``resilience.faults``) and the
rank heartbeats (``store``).
"""
from paddle_tpu_torch.distributed.collective import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    all_to_all_single, barrier, batch_isend_irecv, broadcast,
    broadcast_object_list, destroy_process_group, gather, get_group, irecv,
    is_available, isend, monitored_barrier, new_group, partial_allgather,
    partial_recv, partial_send, recv, reduce, reduce_scatter, scatter,
    scatter_object_list, send, stream, wait)
from paddle_tpu_torch.distributed.env import (  # noqa: F401
    ParallelEnv, get_rank, get_world_size)
from paddle_tpu_torch.distributed.parallel import (  # noqa: F401
    DataParallel, get_backend, init_parallel_env, is_initialized)
from paddle_tpu_torch.distributed.spawn import spawn  # noqa: F401
from paddle_tpu_torch.distributed.utils import (  # noqa: F401
    global_gather, global_scatter)
from paddle_tpu_torch.distributed.launch.main import launch  # noqa: F401
from paddle_tpu_torch.distributed import rpc  # noqa: F401
from paddle_tpu_torch.distributed.mesh import (  # noqa: F401
    build_mesh, get_mesh, set_mesh)
from paddle_tpu_torch.distributed.auto_parallel.api import (  # noqa: F401
    Partial, Placement, ProcessMesh, Replicate, Shard, dtensor_from_fn,
    dtensor_from_local, reshard, shard_dataloader, shard_layer,
    shard_optimizer, shard_tensor, to_static, unshard_dtensor)
