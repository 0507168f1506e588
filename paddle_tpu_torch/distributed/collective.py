"""Collective communication on ``torch.distributed``
(``paddle_tpu.distributed.collective`` counterpart; reference:
python/paddle/distributed/communication/*).

The JAX package runs one SPMD process and lowers a collective to a ``lax``
collective over named mesh axes inside ``shard_map``; a single process
there holds the whole logical value, so its eager collectives are
identities. The port runs one OS process per rank, so every ``Group``
here has real ranks: a ``Group`` is its sorted global ranks plus the
``torch.distributed`` process group that joins them, and every op is the
c10d collective over it, in place on the caller's tensor as Paddle's ops
are. Ranks are global ranks (``src``, ``dst`` and ``peer`` included), as
in the reference API.

Groups on the ``gloo`` backend carry CUDA tensors through host memory:
each op copies its CUDA operands to the host, runs gloo there and copies
the result back (gloo's own CUDA paths cover a few ops only). ``stats()``
counts each op's calls, the bytes it hands to the backend and the host
seconds it takes (staging included, until the op returns), by op name,
until ``reset_stats()``.

Every op has finished when it returns, ``sync_op=False`` included (the
argument is accepted and ignored, as in the JAX package): it returns the
tensor or list it wrote. ``isend``/``irecv`` and ``all_gather_async``
(ZeRO-3's gather ahead) are the asynchronous ops.

The collectives are not differentiable (as ``torch.distributed``'s are
not); the tensor-parallel layers put them inside their own autograd
Functions (``fleet.layers.mpu.mp_ops``).
"""
from __future__ import annotations

import contextlib
import pickle
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from paddle_tpu_torch.distributed.env import get_rank as _global_rank
from paddle_tpu_torch.distributed.env import get_world_size

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "all_reduce", "all_gather",
    "all_gather_async", "all_gather_object", "all_to_all",
    "all_to_all_single", "reduce", "reduce_scatter", "broadcast",
    "broadcast_object_list", "scatter", "gather", "send", "recv", "isend",
    "irecv", "partial_send", "partial_recv", "partial_allgather", "barrier",
    "wait", "P2POp", "batch_isend_irecv", "stream", "scatter_object_list",
    "is_available", "get_backend", "destroy_process_group",
    "monitored_barrier", "stats", "reset_stats",
]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _torch_op(op):
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
            ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT}[op]


@dataclass(eq=False)
class Group:
    """A communication group: sorted global ranks and the c10d process
    group over them (None on a rank outside the group). Group 0 is the
    world."""

    id: int = 0
    ranks: tuple = ()
    pg: object = None
    name: str = ""
    _members: frozenset = field(default=frozenset(), repr=False)

    def __post_init__(self):
        self.ranks = tuple(sorted(int(r) for r in self.ranks))
        self._members = frozenset(self.ranks)

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    def is_member(self) -> bool:
        return _global_rank() in self._members

    @property
    def rank(self) -> int:
        """This process's index in the group (-1 outside it)."""
        r = _global_rank()
        return self.ranks.index(r) if r in self._members else -1

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(int(rank))

    @property
    def process_group(self):
        return self.pg

    @property
    def backend(self) -> str:
        return dist.get_backend(self.pg) if self.pg is not None else ""


_GROUPS: dict[int, Group] = {}
_next_gid = [1]
_STATS: dict[str, dict] = {"calls": {}, "bytes": {}, "seconds": {}}


def stats() -> dict:
    """{"calls": {op: n}, "bytes": {op: bytes}, "seconds": {op: s}} since
    ``reset_stats``."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_stats() -> None:
    for v in _STATS.values():
        v.clear()


def _count(op: str, nbytes: int) -> None:
    _STATS["calls"][op] = _STATS["calls"].get(op, 0) + 1
    _STATS["bytes"][op] = _STATS["bytes"].get(op, 0) + int(nbytes)


@contextlib.contextmanager
def _timed(op: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sec = _STATS["seconds"]
        sec[op] = sec.get(op, 0.0) + time.perf_counter() - t0


def _require_init():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the collectives need init_parallel_env() "
                           "(a torch.distributed process group)")


def _world_group() -> Group:
    _require_init()
    g = _GROUPS.get(0)
    if g is None or g.nranks != get_world_size():
        g = Group(id=0, ranks=tuple(range(get_world_size())),
                  pg=dist.group.WORLD, name="world")
        _GROUPS[0] = g
    return g


def new_group(ranks=None, backend=None, timeout=None, name="") -> Group:
    """A group over `ranks` (all ranks when None). Every rank of the world
    must call it, in the same order, for every group, members or not (the
    c10d rule)."""
    _require_init()
    ranks = sorted(range(get_world_size()) if ranks is None else ranks)
    kw = {"backend": backend} if backend else {}
    if timeout is not None:
        kw["timeout"] = timeout
    pg = dist.new_group(ranks, **kw)
    if pg is dist.GroupMember.NON_GROUP_MEMBER:
        pg = None
    gid = _next_gid[0]
    _next_gid[0] += 1
    g = Group(id=gid, ranks=tuple(ranks), pg=pg, name=name)
    _GROUPS[gid] = g
    return g


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _world_group()
    return _GROUPS[gid]


def _resolve(group) -> Group:
    g = group if group is not None else _world_group()
    if not g.is_member():
        raise ValueError(f"rank {_global_rank()} is not in group {g.ranks}")
    return g


def _staged(g: Group, t: torch.Tensor) -> bool:
    return t.is_cuda and g.backend == "gloo"


def _in_place(g: Group, tensor: torch.Tensor, fn, opname: str):
    """Run ``fn(buffer)`` (a c10d op writing the buffer) on `tensor`, staged
    through the host on gloo, and write the result back."""
    _count(opname, tensor.numel() * tensor.element_size())
    with _timed(opname):
        if _staged(g, tensor) or not tensor.is_contiguous():
            buf = (tensor.detach().cpu() if _staged(g, tensor)
                   else tensor.detach().contiguous())
            fn(buf)
            with torch.no_grad():
                tensor.copy_(buf)
        else:
            fn(tensor.data)
    return tensor


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce `tensor` over the group in place (``AVG`` is the sum divided
    by the group's size)."""
    g = _resolve(group)
    if g.nranks > 1:
        _in_place(g, tensor, lambda b: dist.all_reduce(
            b, op=_torch_op(op), group=g.pg), "all_reduce")
        if op == ReduceOp.AVG:
            with torch.no_grad():
                tensor.div_(g.nranks)
    return tensor


def _gather_bufs(g, tensor):
    if g.nranks == 1:
        return [tensor.detach().clone()]
    src_bytes = tensor.numel() * tensor.element_size()
    _count("all_gather", src_bytes)
    with _timed("all_gather"):
        src = tensor.detach().cpu() if _staged(g, tensor) else \
            tensor.detach().contiguous()
        outs = [torch.empty_like(src) for _ in range(g.nranks)]
        dist.all_gather(outs, src, group=g.pg)
        return [o.to(tensor.device) for o in outs]


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Each member's `tensor`, in member order: appended to `tensor_list`
    when it is a list, else returned stacked."""
    g = _resolve(group)
    outs = _gather_bufs(g, tensor)
    if isinstance(tensor_list, list):
        tensor_list.extend(outs)
        return tensor_list
    return torch.stack(outs, 0)


class _GatherWork:
    """An ``all_gather_async`` in flight; ``wait()`` completes it (and,
    staged, copies the host result into the caller's tensor)."""

    def __init__(self, work, keep=None, host=None, dest=None):
        # `keep` holds the input (its host copy) until the op completes
        self._work, self._keep, self._host, self._dest = work, keep, host, dest

    def wait(self):
        if self._work is None:
            return True
        with _timed("all_gather_async"):
            self._work.wait()
            if self._dest is not None:
                with torch.no_grad():
                    self._dest.copy_(self._host, non_blocking=True)
        self._work = self._keep = self._host = self._dest = None
        return True


def all_gather_async(out_tensor, tensor, group=None):
    """Start gathering every member's 1-D `tensor` into the 1-D
    `out_tensor` (``nranks * numel`` elements, member order) and return
    its task; ``wait()`` it before reading `out_tensor`. The op is in
    flight between the two (c10d's asynchronous work). On gloo a CUDA
    input is copied to pinned host memory when the op starts and the
    result back to the card when it is waited on. ``stats()`` counts it
    under "all_gather_async": its calls, the bytes of the input, and the
    host seconds of the start and of the wait."""
    g = _resolve(group)
    n = tensor.numel()
    if tensor.dim() != 1 or out_tensor.numel() != n * g.nranks:
        raise ValueError(f"all_gather_async: a 1-D input of {n} elements "
                         f"gathers into {n * g.nranks}, not "
                         f"{out_tensor.numel()}")
    if g.nranks == 1:
        with torch.no_grad():
            out_tensor.view(-1).copy_(tensor)
        return _GatherWork(None)
    _count("all_gather_async", n * tensor.element_size())
    with _timed("all_gather_async"):
        src = tensor.detach().contiguous()
        if _staged(g, tensor):
            host_in = torch.empty(n, dtype=tensor.dtype, pin_memory=True)
            host_in.copy_(src)
            host = torch.empty(n * g.nranks, dtype=tensor.dtype,
                               pin_memory=True)
            work = dist.all_gather(list(host.chunk(g.nranks)), host_in,
                                   group=g.pg, async_op=True)
            return _GatherWork(work, host_in, host, out_tensor.view(-1))
        if g.backend == "nccl":
            work = dist.all_gather_into_tensor(out_tensor.view(-1), src,
                                               group=g.pg, async_op=True)
        else:
            work = dist.all_gather(list(out_tensor.view(-1).chunk(g.nranks)),
                                   src, group=g.pg, async_op=True)
        return _GatherWork(work, src)


def all_gather_object(object_list: list, obj, group=None):
    g = _resolve(group)
    outs = [None] * g.nranks
    if g.nranks > 1:
        dist.all_gather_object(outs, obj, group=g.pg)
    else:
        outs[0] = obj
    object_list.extend(outs)
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce onto global rank `dst`; only its buffer changes."""
    g = _resolve(group)
    if g.nranks > 1:
        keep = None if _global_rank() == dst else tensor.detach().clone()
        _in_place(g, tensor, lambda b: dist.reduce(
            b, dst=int(dst), op=_torch_op(op), group=g.pg), "reduce")
        with torch.no_grad():
            if keep is not None:
                tensor.copy_(keep)
            elif op == ReduceOp.AVG:
                tensor.div_(g.nranks)
    return tensor


def _rs_single():
    return getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """`tensor` = member i's block (dim 0) of the group's reduction of the
    input (a list of equal blocks or one tensor of nranks blocks)."""
    g = _resolve(group)
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.cat([t.reshape((1,) + tuple(t.shape)) if t.dim() == 0
                         else t for t in src], 0)
    if src.shape[0] % g.nranks:
        raise ValueError(f"reduce_scatter: dim 0 ({src.shape[0]}) is not "
                         f"a multiple of the group size {g.nranks}")
    if g.nranks == 1:
        with torch.no_grad():
            tensor.copy_(src.reshape(tensor.shape))
        return tensor
    _count("reduce_scatter", src.numel() * src.element_size())
    with _timed("reduce_scatter"):
        inp = src.detach().cpu() if _staged(g, src) else \
            src.detach().contiguous()
        out = torch.empty((src.shape[0] // g.nranks,)
                          + tuple(src.shape[1:]), dtype=src.dtype,
                          device=inp.device)
        _rs_single()(out, inp, op=_torch_op(op), group=g.pg)
        if op == ReduceOp.AVG:
            out.div_(g.nranks)
        with torch.no_grad():
            tensor.copy_(out.reshape(tensor.shape))
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Global rank `src`'s `tensor` to every member, in place."""
    g = _resolve(group)
    if g.nranks > 1:
        _in_place(g, tensor, lambda b: dist.broadcast(
            b, src=int(src), group=g.pg), "broadcast")
    return tensor


def broadcast_object_list(object_list, src=0, group=None):
    g = _resolve(group)
    if g.nranks > 1:
        dist.broadcast_object_list(object_list, src=int(src), group=g.pg)
    return object_list


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Member i receives ``tensor_list[i]`` of global rank `src`."""
    g = _resolve(group)
    if _global_rank() == src:
        if not tensor_list or len(tensor_list) != g.nranks:
            raise ValueError(f"scatter: the source passes one tensor per "
                             f"member ({g.nranks})")
    if g.nranks == 1:
        with torch.no_grad():
            tensor.copy_(tensor_list[0])
        return tensor
    staged = _staged(g, tensor)
    out = tensor.detach().cpu() if staged else \
        torch.empty_like(tensor).contiguous()
    ins = None
    if _global_rank() == src:
        ins = [(t.detach().cpu() if staged else t.detach().contiguous())
               for t in tensor_list]
    _count("scatter", out.numel() * out.element_size())
    dist.scatter(out, ins, src=int(src), group=g.pg)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Global rank `dst` receives every member's `tensor`, appended to
    `gather_list` in member order."""
    g = _resolve(group)
    if g.nranks == 1:
        if gather_list is not None:
            gather_list.append(tensor.clone())
        return gather_list
    staged = _staged(g, tensor)
    src = tensor.detach().cpu() if staged else tensor.detach().contiguous()
    outs = ([torch.empty_like(src) for _ in range(g.nranks)]
            if _global_rank() == dst else None)
    _count("gather", src.numel() * src.element_size())
    dist.gather(src, outs, dst=int(dst), group=g.pg)
    if outs is not None and gather_list is not None:
        gather_list.extend(o.to(tensor.device) for o in outs)
    return gather_list


def all_to_all_single(out_tensor, in_tensor, in_split_sizes=None,
                      out_split_sizes=None, group=None, sync_op=True):
    """Block j of each member's `in_tensor` (dim 0) goes to member j;
    `out_tensor` holds the blocks received, in member order."""
    g = _resolve(group)
    if g.nranks == 1:
        with torch.no_grad():
            out_tensor.copy_(in_tensor)
        return out_tensor
    staged = _staged(g, in_tensor)
    _count("all_to_all", in_tensor.numel() * in_tensor.element_size())
    with _timed("all_to_all"):
        inp = in_tensor.detach().cpu() if staged else \
            in_tensor.detach().contiguous()
        out = torch.empty(out_tensor.shape, dtype=out_tensor.dtype,
                          device=inp.device)
        dist.all_to_all_single(out, inp, output_split_sizes=out_split_sizes,
                               input_split_sizes=in_split_sizes, group=g.pg)
        with torch.no_grad():
            out_tensor.copy_(out)
    return out_tensor


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Member j receives ``in_tensor_list[j]`` of every member, appended to
    `out_tensor_list` in member order (tensors of one shape)."""
    g = _resolve(group)
    stacked = torch.stack(list(in_tensor_list), 0)
    out = torch.empty_like(stacked)
    all_to_all_single(out, stacked, group=g)
    out_tensor_list.extend(out.unbind(0))
    return out_tensor_list


class _P2PWork:
    """An isend/irecv in flight; ``wait()`` completes it (and, for a
    staged receive, copies the host buffer into the caller's tensor)."""

    def __init__(self, work, buf=None, dest=None):
        # a send keeps its (host) buffer alive until it completes
        self._work, self._buf, self._dest = work, buf, dest

    def wait(self):
        self._work.wait()
        if self._dest is not None:
            with torch.no_grad():
                self._dest.copy_(self._buf)
            self._dest = None
        return True

    def is_completed(self):
        return self._work.is_completed()


def isend(tensor, dst=0, group=None):
    """Send `tensor` to global rank `dst` without waiting."""
    g = group if group is not None else _world_group()
    buf = tensor.detach().cpu() if _staged(g, tensor) else \
        tensor.detach().contiguous()
    _count("send", buf.numel() * buf.element_size())
    return _P2PWork(dist.isend(buf, dst=int(dst), group=g.pg), buf)


def irecv(tensor, src=0, group=None):
    """Receive into `tensor` from global rank `src`; ``wait()`` the task."""
    g = group if group is not None else _world_group()
    _count("recv", tensor.numel() * tensor.element_size())
    if _staged(g, tensor) or not tensor.is_contiguous():
        buf = (torch.empty(tensor.shape, dtype=tensor.dtype)
               if _staged(g, tensor) else torch.empty_like(tensor))
        return _P2PWork(dist.irecv(buf, src=int(src), group=g.pg), buf,
                        tensor)
    return _P2PWork(dist.irecv(tensor.data, src=int(src), group=g.pg))


def send(tensor, dst=0, group=None, sync_op=True):
    isend(tensor, dst, group).wait()
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    irecv(tensor, src, group).wait()
    return tensor


# ---- partial p2p (reference four_directions_p2p_communication.py:208):
# ship only a member's 1/nranks slice of a pipeline activation ------------

def _partial_slice(numel: int, nranks: int, rank_id: int):
    if numel % nranks != 0:
        raise ValueError(f"partial op: numel {numel} not divisible by "
                         f"nranks {nranks}")
    per = numel // nranks
    return rank_id * per, per


def partial_send(tensor, dst=0, nranks=1, rank_id=0, group=None):
    """Send the rank_id-th 1/nranks slice of the flattened tensor."""
    start, per = _partial_slice(tensor.numel(), nranks, rank_id)
    return send(tensor.reshape(-1)[start:start + per], dst=dst, group=group)


def partial_recv(tensor, src=0, nranks=1, rank_id=0, group=None):
    """Receive into the rank_id-th 1/nranks slice of `tensor`, in place."""
    start, per = _partial_slice(tensor.numel(), nranks, rank_id)
    piece = torch.empty((per,), dtype=tensor.dtype, device=tensor.device)
    recv(piece, src=src, group=group)
    with torch.no_grad():
        tensor.view(-1)[start:start + per] = piece
    return tensor


def partial_allgather(tensor, nranks, rank_id, group=None):
    """Every member contributes its own 1/nranks slice of the flattened
    tensor; the slices are gathered back into it in place, in member
    order."""
    g = _resolve(group)
    if g.nranks != nranks:
        raise ValueError(f"partial_allgather: nranks={nranks} != group "
                         f"size {g.nranks}")
    if g.rank != rank_id:
        raise ValueError(f"partial_allgather: rank_id={rank_id} but this "
                         f"rank is member {g.rank}; reassembly is in member "
                         f"order")
    start, per = _partial_slice(tensor.numel(), nranks, rank_id)
    flat = tensor.reshape(-1)
    rows = _gather_bufs(g, flat[start:start + per])
    with torch.no_grad():
        tensor.view(-1).copy_(torch.cat(rows))
    return tensor


@dataclass
class P2POp:
    op: object
    tensor: torch.Tensor
    peer: int
    group: Group | None = None


def batch_isend_irecv(p2p_op_list):
    """Start every op of the list (``isend``/``irecv`` against a global
    peer rank), in list order; returns their tasks (``wait()`` each)."""
    tasks = []
    for op in p2p_op_list:
        if op.op in (isend, send):
            tasks.append(isend(op.tensor, op.peer, op.group))
        elif op.op in (irecv, recv):
            tasks.append(irecv(op.tensor, op.peer, op.group))
        else:
            raise ValueError(f"unsupported P2POp op {op.op!r}")
    return tasks


def barrier(group=None):
    g = _resolve(group)
    if g.nranks > 1:
        _count("barrier", 0)
        dist.barrier(group=g.pg)


def wait(tensor, group=None, use_calc_stream=True):
    """Wait for the work queued on `tensor`'s device (the collectives here
    complete before they return)."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class stream:
    """``paddle.distributed.stream``: the same ops."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    broadcast = staticmethod(broadcast)
    send = staticmethod(send)
    recv = staticmethod(recv)
    all_to_all = staticmethod(all_to_all)
    scatter = staticmethod(scatter)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Global rank `src` hands one Python object to each member."""
    g = _resolve(group)
    mine = [None]
    if g.nranks > 1:
        dist.scatter_object_list(
            mine, list(in_object_list) if _global_rank() == src else None,
            src=int(src), group=g.pg)
    else:
        mine = [pickle.loads(pickle.dumps((in_object_list or [None])[0]))]
    out_object_list[:] = mine
    return out_object_list


def is_available() -> bool:
    return dist.is_available()


def get_backend(group=None) -> str:
    """The c10d backend of `group` (the world's when None): 'nccl' or
    'gloo'."""
    return _resolve(group).backend


def destroy_process_group(group=None):
    """Leave the process group (all of it when `group` is None) and forget
    the groups made on it."""
    from paddle_tpu_torch.distributed import parallel

    if group is not None and group.id != 0:
        if group.pg is not None:
            dist.destroy_process_group(group.pg)
        _GROUPS.pop(group.id, None)
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()
    parallel._reset()


def monitored_barrier(group=None, timeout=None):
    """A barrier that names the ranks that did not arrive (gloo's
    ``monitored_barrier``; the plain barrier on other backends)."""
    g = _resolve(group)
    if g.nranks > 1 and g.backend == "gloo":
        kw = {"timeout": timeout} if timeout is not None else {}
        _count("barrier", 0)
        dist.monitored_barrier(group=g.pg, **kw)
    else:
        barrier(g)
