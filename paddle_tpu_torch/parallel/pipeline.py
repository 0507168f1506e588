"""Pipeline-parallel training, a process a rank (``paddle_tpu.parallel.
pipeline`` counterpart; reference: Fleet's 1F1B runtime,
pipeline_parallel.py:459 ``forward_backward_pipeline``, the interleaved
runtime :1010, batched p2p pp_utils/p2p_communication.py:322).

The JAX package runs its pipeline as one SPMD program: each pp device
holds one stage, a ``lax.scan`` streams the microbatches, activations hop
by ``lax.ppermute`` and autodiff of the scan gives the backward. The port
runs one process a rank (``ROADMAP.md`` C, "Hybrid parallelism runs a
process per rank"): each pp rank holds only its stage's layers, and walks
its column of a schedule table tick by tick:

* an F tick runs the stage on its input (the embedding's ids on the first
  stage, else the activation received from the previous stage) and keeps
  the autograd graph; the last stage ends in the head and the loss, the
  fused head loss (``parallel.fused_head``) where the head and loss allow;
* a B tick runs ``torch.autograd.backward`` from the received cotangent
  (the last stage from its microbatch loss) and the input's gradient goes
  back to the previous stage.

Every rank knows the table, so each tick's hops are matched within the
tick: after its compute a rank posts, in one ``batch_isend_irecv``, the
sends of what it produced and the receives of what its neighbours produce
at the same tick, activations before cotangents, even pp ranks sending
before receiving and odd ones receiving first; then it waits for them.
The hops run on the pp group through ``distributed.collective``: gloo on
the CPU and for ranks that share a card (staged through host memory),
nccl for ranks that own one. Each (dp, mp) coordinate talks to the same
coordinate of the neighbouring stage. ``collective.stats()`` counts the
hops under "send"/"recv" (calls, bytes) and their host time under "p2p".

Schedules: ``one_f_one_b_schedule(S, M)`` (1F1B: at most S - r
microbatches in flight on rank r); with ``virtual_pp`` V > 1 the forward
follows ``_interleave_schedule(S, V, M)`` (the Megatron virtual-stage
ring, position p = chunk * S + rank) and the backward mirrors the forward
table in reverse, the order JAX's autodiff of its scan gives (an
interleaved-1F1B order is later speed work, ``ROADMAP.md`` A8); ZB-H1 is
``parallel.zero_bubble``.

Microbatch m is rows [m*mb, (m+1)*mb) of the global batch, and a data
rank takes its block of those rows (JAX ``pipeline.py:543-552``). The
loss is the mean over microbatches of each microbatch's loss, then the
mean over the data ranks, broadcast from the last stage over pp: every
rank returns the same loss. Gradients of replicated parameters are
averaged over dp by ``HybridParallelOptimizer``; its global norm sums the
squares over pp (each stage holds other parameters).

ZeRO inside a stage (``zero_axis=``, JAX ``pipeline.py:231-296``): the
stage's blocks persist as this rank's 1/N of each block over the zero
axis, a data axis the microbatch rows split over (dp or sharding; "dp"
is taken as the sharding axis when the mesh has no sharding axis above
1). Each microbatch's F tick runs the blocks through the ZeRO-3 layer
loop (``scan_layers.zero3_layer_loop``), block i+1's all-gather in flight
while block i computes, and its B tick the mirror: the blocks are
gathered again and recomputed (the "full" grade), and their gradients
reduce-scattered. The embedding and the head stay replicated, with ZeRO-1
optimizer state. VPP with a zero axis, a zero axis that is no data axis
and microbatch rows that do not split over the data axes raise, as in
JAX; an axis the mesh lacks warns and leaves ZeRO off. ZB-H1's variant is
``parallel.zero_bubble``'s.

Not ported (ROADMAP A8): fp8 under pp (the JAX package's stateless
current scaling, ``pipeline.py:165-171``) raises.
"""
from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.parallel.pipeline_schedules import (
    fthenb_schedule, one_f_one_b_schedule)
from paddle_tpu_torch.parallel.scan_layers import (normalize_remat,
                                                   unrolled_layer_call,
                                                   zero3_layer_loop)
from paddle_tpu_torch.parallel.segments import segment_execution

__all__ = ["PipelinedTrainStep", "PipelineEngine", "StagePart",
           "stage_block_indices", "pipeline_hcg", "PP_FP8_NOT_PORTED"]

PP_FP8_NOT_PORTED = ("fp8 under pp is not ported yet (ROADMAP A8 item 8, "
                     "fp8 under the pipeline)")

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)


def _interleave_schedule(S: int, v: int, M: int):
    """The interleaved-VPP forward table (drain-first priority, reference
    PipelineParallelWithInterleave, pipeline_parallel.py:1010; the JAX
    package's table, ``pipeline.py:51-140``).

    The virtual ring has S*v positions; position p = chunk*S + rank. Each
    tick every rank processes at most ONE chunk and the result hops to
    the next rank. Drain-first priority + inject-when-idle gives
    T = M*v + S - 1 chunk-ticks.

    Returns numpy int/bool arrays indexed [T, S]:
      proc_chunk, proc_valid, inject_mb (-1 = none), out_valid, out_mb,
      dst_chunk, dst_valid (where the sent activation lands next tick),
      and proc_mb (the microbatch each processing tick runs; the port's
      runtime needs it, the JAX package's scan does not).
    """
    positions = {}  # p -> mb currently WAITING at p
    next_inject = 0
    proc_chunk, proc_valid, inject_mb, out_valid, out_mb = [], [], [], [], []
    proc_mb = []
    exited = 0
    t = 0
    max_ticks = M * v + 2 * S * v + 4
    while exited < M and t < max_ticks:
        pc = [0] * S
        pv = [False] * S
        im = [-1] * S
        ov = [False] * S
        om = [0] * S
        pm = [-1] * S
        moved = {}  # p_dst -> mb arriving at t+1
        busy = [False] * S
        # process in descending position order (drain-first); a rank takes
        # the furthest-along waiting activation whose destination is free
        for p in sorted(positions.keys(), reverse=True):
            r = p % S
            if busy[r]:
                continue
            dst = p + 1
            if dst < S * v and (dst in positions or dst in moved):
                continue  # destination occupied and not vacating
            m = positions.pop(p)
            busy[r] = True
            pc[r] = p // S
            pv[r] = True
            pm[r] = m
            if dst == S * v:
                ov[r] = True
                om[r] = m
                exited += 1
            else:
                moved[dst] = m
        # inject at rank 0 chunk 0 when idle and station 0 path free
        if (not busy[0]) and next_inject < M and 0 not in positions \
                and 0 not in moved:
            m = next_inject
            next_inject += 1
            busy[0] = True
            pc[0] = 0
            pv[0] = True
            im[0] = m
            pm[0] = m
            if S * v == 1:
                ov[0] = True
                om[0] = m
                exited += 1
            else:
                moved[1] = m
        for p, m in moved.items():
            assert p not in positions, f"station collision at p={p} t={t}"
            positions[p] = m
        proc_chunk.append(pc)
        proc_valid.append(pv)
        inject_mb.append(im)
        out_valid.append(ov)
        out_mb.append(om)
        proc_mb.append(pm)
        t += 1
    assert exited == M, f"schedule did not drain: {exited}/{M} in {t} ticks"
    T = t
    proc_chunk = np.array(proc_chunk, np.int32)
    proc_valid = np.array(proc_valid, bool)
    inject_mb = np.array(inject_mb, np.int32)
    out_valid = np.array(out_valid, bool)
    out_mb = np.array(out_mb, np.int32)
    # destination bookkeeping: rank r receives what rank r-1 processed
    dst_chunk = np.zeros((T, S), np.int32)
    dst_valid = np.zeros((T, S), bool)
    for tt in range(T):
        for r in range(S):
            src = (r - 1) % S
            if proc_valid[tt, src] and not out_valid[tt, src]:
                dst_chunk[tt, r] = proc_chunk[tt, src] + (1 if r == 0 else 0)
                dst_valid[tt, r] = True
    return dict(T=T, proc_chunk=proc_chunk, proc_valid=proc_valid,
                inject_mb=inject_mb, out_valid=out_valid, out_mb=out_mb,
                dst_chunk=dst_chunk, dst_valid=dst_valid,
                proc_mb=np.array(proc_mb, np.int32))


class StagePart:
    """One part (a chunk) of this rank's stage: its ring `position`, the
    callables it runs in order, which of them are blocks (a remat policy
    wraps those one by one), whether it takes the ids (position 0) and
    whether it ends in the head and the loss (the last position)."""

    def __init__(self, position, fns, blocks, first, last):
        self.position = int(position)
        self.fns = list(fns)
        self.blocks = list(blocks)
        self.first = bool(first)
        self.last = bool(last)


class _P2P:
    """The tick-matched hops of one pp rank (see the module docstring).
    An activation's shape and dtype travel once per (position, batch
    shape), in a small header before the first payload."""

    def __init__(self, pp_group, stage, S, device):
        self.S, self.stage, self.device = S, stage, device
        self.group = pp_group
        ranks = pp_group.ranks
        self.next = ranks[(stage + 1) % S]
        self.prev = ranks[(stage - 1) % S]
        self._sent, self._meta = set(), {}

    def _post(self, ops):
        order = sorted(range(len(ops)), key=lambda i: (
            (ops[i][0] == "send") == (self.stage % 2 == 1), i))
        works = collective.batch_isend_irecv([
            collective.P2POp(collective.isend if ops[i][0] == "send"
                             else collective.irecv, ops[i][2], ops[i][1],
                             self.group) for i in order])
        for w in works:
            w.wait()

    def exchange(self, sends, recvs):
        """`sends`: [(peer, tensor, meta_key or None)]; `recvs`: [(peer,
        meta_key, (shape, dtype) or None)], in activation-then-cotangent
        order. Returns the received tensors."""
        if not sends and not recvs:
            return []
        with collective._timed("p2p"):
            head = []
            for peer, t, key in sends:
                if key is not None and key not in self._sent:
                    self._sent.add(key)
                    code = _DTYPES.index(t.dtype)
                    meta = torch.tensor([code, t.dim()] + list(t.shape)
                                        + [0] * (8 - t.dim()),
                                        dtype=torch.int64)
                    head.append(("send", peer, meta))
            want = []
            for i, (peer, key, sd) in enumerate(recvs):
                if sd is None and key not in self._meta:
                    buf = torch.empty(10, dtype=torch.int64)
                    head.append(("recv", peer, buf))
                    want.append((key, buf))
            if head:
                self._post(head)
                for key, buf in want:
                    v = buf.tolist()
                    self._meta[key] = (tuple(v[2:2 + v[1]]), _DTYPES[v[0]])
            bufs = []
            ops = [("send", peer, t.detach().contiguous())
                   for peer, t, _ in sends]
            for peer, key, sd in recvs:
                shape, dtype = sd if sd is not None else self._meta[key]
                bufs.append(torch.empty(shape, dtype=dtype,
                                        device=self.device))
                ops.append(("recv", peer, bufs[-1]))
            self._post(ops)
        return bufs


class PipelineEngine:
    """One pp rank's share of a pipeline and the schedules that run it.

    `parts`: this rank's ``StagePart``s in chunk order (one without VPP);
    `loss_fn(out, labels)` (or the fused head loss when the last part's
    head and `loss_fn` allow); `hcg`: the hybrid group (pp, dp, mp);
    `replicate`: every data rank takes the whole batch (ZB-H1's rule)."""

    def __init__(self, parts, loss_fn, hcg, num_micro, remat="none",
                 replicate=False, device=None):
        from paddle_tpu_torch.parallel.fused_head import fused_head_spec

        self.parts = list(parts)
        self.loss_fn = loss_fn
        self.hcg = hcg
        self.M = int(num_micro)
        self.S = hcg.get_pipe_parallel_world_size()
        self.V = len(self.parts)
        self.stage = hcg.get_stage_id()
        self.remat_policy = normalize_remat(remat)
        self.replicate = bool(replicate)
        self.data_group = (None if replicate
                           else hcg.get_dp_sharding_parallel_group())
        if device is None:
            device = next((p.device for part in self.parts
                           for fn in part.fns if isinstance(
                               fn, torch.nn.Module)
                           for p in fn.parameters()), torch.device("cpu"))
        self.device = torch.device(device)
        self.p2p = _P2P(hcg.get_pipe_parallel_group(), self.stage, self.S,
                        self.device)
        last = self.parts[-1]
        self._head = None
        self._fused = None
        if last.last and last.fns and isinstance(last.fns[-1],
                                                 torch.nn.Module):
            spec = fused_head_spec(last.fns[-1], loss_fn)
            if spec is not None:
                self._head, self._fused = last.fns[-1], spec
        self.sink = None          # ZB-H1's weight-gradient deferral
        self.zero = None          # the ZeRO-3 loop's ScanShardInfo

    # ---- batches ------------------------------------------------------------
    def microbatches(self, value):
        """[M] of this data rank's rows of each microbatch of `value`
        (numpy or tensor, [global rows, ...]), on the engine's device."""
        if value is None:
            return None
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        n = value.shape[0]
        if n % self.M:
            raise ValueError(f"a batch of {n} rows does not split into "
                             f"{self.M} microbatches")
        mb = n // self.M
        g = self.data_group
        k, off = mb, 0
        if g is not None and g.nranks > 1:
            if mb % g.nranks:
                raise ValueError(f"a microbatch of {mb} rows does not split "
                                 f"over {g.nranks} data ranks")
            k = mb // g.nranks
            off = g.rank * k
        return [value[m * mb + off:m * mb + off + k].to(
            self.device, non_blocking=True) for m in range(self.M)]

    # ---- one part on one microbatch -----------------------------------------
    def run_part(self, part, x, m, labels, extras):
        """The part's callables on `x` (ids on the first part); on the last
        part the microbatch's fp32 loss."""
        fns = part.fns
        fused = part.last and self._fused is not None
        if fused:
            fns = fns[:-1]
        ctx = (segment_execution(extras["segment_ids"][m]
                                 if "segment_ids" in extras else None,
                                 extras["position_ids"][m]
                                 if "position_ids" in extras else None)
               if extras else nullcontext())
        marks = part.blocks[:len(fns)]
        with ctx:
            i = 0
            while i < len(fns):
                fn, blk = fns[i], marks[i]
                if blk and self.zero is not None:
                    j = i
                    while j < len(fns) and marks[j]:
                        j += 1
                    x = zero3_layer_loop(fns[i:j], x, (), {}, self.zero)
                    i = j
                    continue
                if blk and self.remat_policy != "none":
                    x = unrolled_layer_call(fn, x, (), {}, self.remat_policy)
                else:
                    x = fn(*x) if isinstance(x, tuple) else fn(x)
                i += 1
            if not part.last:
                return x
            from paddle_tpu_torch.parallel.fused_head import fused_head_loss

            if fused:
                return fused_head_loss(self._head, x, labels[m],
                                       self._fused).float()
            return self.loss_fn(x, labels[m]).float()

    # ---- the schedules --------------------------------------------------------
    def _table_hops(self, row):
        """What the neighbours send to this rank at a tick of a V = 1
        table: (the microbatch of the previous stage's F activation, of the
        next stage's B cotangent), None where nothing comes."""
        s, S = self.stage, self.S
        act = row[s - 1] if s > 0 else None
        cot = row[s + 1] if s < S - 1 else None
        return ((act[1] if act is not None and act[0] == "F" else None),
                (cot[1] if cot is not None and cot[0] == "B" else None))

    def run_table(self, sched, ids, labels, extras, grad_scale=1.0,
                  train=True):
        """Walk this rank's column of a V = 1 table (FThenB, 1F1B, ZB-H1):
        returns the list of microbatch losses (the last stage's; empty
        elsewhere). `grad_scale` multiplies each microbatch loss before
        its backward (1/M, times a loss scale)."""
        part = self.parts[0]
        s, S = self.stage, self.S
        bshape = tuple(ids[0].shape)
        act_in, cot_in, kept = {}, {}, {}
        losses = [None] * self.M
        for row in sched["ticks"]:
            job = row[s]
            sends = []
            if job is not None:
                op, m, _ = job
                if op == "F":
                    x = ids[m] if part.first else act_in.pop(m)
                    if not part.first and train:
                        x.requires_grad_(True)
                    with (nullcontext() if train else torch.no_grad()):
                        with (self.sink.forward(m) if self.sink is not None
                              else nullcontext()):
                            y = self.run_part(part, x, m, labels, extras)
                    if part.last:
                        losses[m] = y.detach()
                    else:
                        sends.append((self.p2p.next, y,
                                      ("act", part.position, bshape)))
                    if train:
                        kept[m] = (x, y)
                elif op == "B":
                    x, y = kept.pop(m)
                    with (self.sink.backward(m) if self.sink is not None
                          else nullcontext()):
                        if part.last:
                            (y * grad_scale).backward()
                        else:
                            torch.autograd.backward(y, cot_in.pop(m))
                    if not part.first:
                        sends.append((self.p2p.prev, x.grad, None))
                elif op == "W":
                    self.sink.run_w(m)
            a_mb, c_mb = self._table_hops(row)
            recvs = []
            if a_mb is not None:
                recvs.append((self.p2p.prev,
                              ("act", part.position - 1, bshape), None))
            if c_mb is not None:
                y_m = kept[c_mb][1]
                recvs.append((self.p2p.next, None, (tuple(y_m.shape),
                                                    y_m.dtype)))
            got = self.p2p.exchange(sends, recvs)
            if a_mb is not None:
                act_in[a_mb] = got.pop(0)
            if c_mb is not None:
                cot_in[c_mb] = got.pop(0)
        assert not kept and not act_in and not cot_in
        return [v for v in losses if v is not None]

    def run_vpp(self, ids, labels, extras, sched, grad_scale=1.0):
        """The interleaved forward table, then its mirror backward."""
        s, S, V = self.stage, self.S, self.V
        bshape = tuple(ids[0].shape)
        last_pos = S * V - 1
        pc, pv, pm = sched["proc_chunk"], sched["proc_valid"], sched["proc_mb"]
        dv, dc = sched["dst_valid"], sched["dst_chunk"]
        waiting, kept, losses = {}, {}, {}
        for t in range(sched["T"]):
            sends = []
            if pv[t, s]:
                k, m = int(pc[t, s]), int(pm[t, s])
                part = self.parts[k]
                p = part.position
                x = ids[m] if p == 0 else waiting.pop((p, m))
                if p != 0:
                    x.requires_grad_(True)
                y = self.run_part(part, x, m, labels, extras)
                kept[(p, m)] = (x, y)
                if p == last_pos:
                    losses[m] = y.detach()
                else:
                    sends.append((self.p2p.next, y, ("act", p, bshape)))
            recvs = []
            if dv[t, s]:
                p_in = int(dc[t, s]) * S + s
                m_in = int(pm[t, (s - 1) % S])
                recvs.append((self.p2p.prev, ("act", p_in - 1, bshape),
                              None))
            got = self.p2p.exchange(sends, recvs)
            if dv[t, s]:
                waiting[(p_in, m_in)] = got[0]
        assert not waiting
        dx = {}
        for t in reversed(range(sched["T"])):
            # the mirror of forward tick t's hops, then its compute
            sends, recvs = [], []
            if dv[t, s]:
                p_in = int(dc[t, s]) * S + s
                m_in = int(pm[t, (s - 1) % S])
                sends.append((self.p2p.prev, dx.pop((p_in, m_in)), None))
            item = None
            if pv[t, s]:
                k, m = int(pc[t, s]), int(pm[t, s])
                item = (self.parts[k].position, m)
                if item[0] != last_pos:
                    y = kept[item][1]
                    recvs.append((self.p2p.next, None,
                                  (tuple(y.shape), y.dtype)))
            got = self.p2p.exchange(sends, recvs)
            if item is not None:
                x, y = kept.pop(item)
                if item[0] == last_pos:
                    (y * grad_scale).backward()
                else:
                    torch.autograd.backward(y, got[0])
                if item[0] != 0:
                    dx[item] = x.grad
        assert not kept and not dx
        return [losses[m] for m in sorted(losses)]

    def forward_backward(self, ids, labels, extras=None, loss_scale=1.0,
                         train=True, schedule=None):
        """One step's forward and backward (gradients accumulate in
        ``.grad``); returns the step loss (fp32 scalar, the same on every
        rank of the pp and data groups)."""
        ids_mb = self.microbatches(ids)
        lab_mb = self.microbatches(labels)
        ex_mb = {k: self.microbatches(v) for k, v in (extras or {}).items()
                 if v is not None}
        scale = float(loss_scale) / self.M
        if not train:
            sched = fthenb_schedule(self.S, self.M)
            sched = dict(sched, ticks=sched["ticks"][:self.M + self.S - 1])
            losses = self.run_table(sched, ids_mb, lab_mb, ex_mb,
                                    train=False)
        elif self.V > 1:
            losses = self.run_vpp(ids_mb, lab_mb, ex_mb,
                                  _interleave_schedule(self.S, self.V,
                                                       self.M), scale)
        else:
            sched = schedule or one_f_one_b_schedule(self.S, self.M)
            losses = self.run_table(sched, ids_mb, lab_mb, ex_mb, scale)
        return self.reduce_loss(losses)

    def reduce_loss(self, losses):
        """The mean of the microbatch losses on the last stage, averaged
        over the data ranks and broadcast over pp."""
        if losses:
            loss = torch.stack(losses).float().sum() / self.M
        else:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
        g = self.data_group
        if g is not None and g.nranks > 1 and losses:
            collective.all_reduce(loss, collective.ReduceOp.AVG, g)
        pp = self.hcg.get_pipe_parallel_group()
        if pp.nranks > 1:
            collective.broadcast(loss, src=pp.ranks[self.S - 1], group=pp)
        return loss


def pipeline_hcg(mesh, zero_axis=None):
    """The hcg of a rank mesh with a pp axis (``fleet.init`` over the
    mesh's degrees, so the mp layers built afterwards see it). With a
    `zero_axis` the strategy's sharding stage is 3, and "dp" becomes the
    sharding axis when the mesh has no sharding axis above 1."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import set_mesh

    if mesh.shape.get("ep", 1) > 1:
        raise NotImplementedError("expert parallelism under pp is not "
                                  "ported yet (ROADMAP A8)")
    if mesh.shape.get("sep", 1) > 1:
        # nothing here splits the sequence: the stages would train it
        # replicated
        raise NotImplementedError("sequence parallelism (sep > 1) under pp "
                                  "is not ported yet (ROADMAP A8)")
    set_mesh(mesh)
    dp, sharding = mesh.shape.get("dp", 1), mesh.shape.get("sharding", 1)
    if zero_axis == "dp" and sharding == 1:
        dp, sharding = 1, dp
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {
        "pp_degree": mesh.shape.get("pp", 1),
        "dp_degree": dp,
        "mp_degree": mesh.shape.get("mp", 1),
        "sharding_degree": sharding,
        "sep_degree": mesh.shape.get("sep", 1)}
    if zero_axis is not None:
        strategy.sharding_configs = dict(strategy.sharding_configs,
                                         stage=3)
    return fleet.init(strategy=strategy), strategy


def sync_replicas(modules, hcg):
    """Broadcast the parameters replicated across mp (the mp shards stay)
    and all of them across dp, as ``TensorParallel`` does at wrap."""
    from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util \
        import broadcast_dp_parameters, broadcast_mp_parameters

    holder = torch.nn.ModuleList([m for m in modules
                                  if isinstance(m, torch.nn.Module)])
    if hcg.get_model_parallel_world_size() > 1:
        broadcast_mp_parameters(holder, hcg)
    if hcg.get_data_parallel_world_size() > 1:
        broadcast_dp_parameters(holder, hcg)


def check_unported(fp8_policy):
    """Raise for what the pipelines leave to ROADMAP A8."""
    from paddle_tpu_torch.amp import fp8 as _fp8
    from paddle_tpu_torch.core.flags import flag

    policy = _fp8.normalize_fp8_policy(
        flag("fp8_policy") if fp8_policy is None else fp8_policy)
    if policy != "none":
        raise NotImplementedError(PP_FP8_NOT_PORTED)


class PipelinedTrainStep:
    """The pipelined train step for (embed, blocks, head) models over a
    rank mesh with a "pp" axis (+ dp, mp).

    Stage-local: on pp rank s, `blocks` are this rank's decoder blocks in
    chunk order (``V * bpc`` of them: chunk c holds the model's blocks
    [(c*S + s)*bpc, (c*S + s + 1)*bpc), see ``stage_block_indices``);
    `embed_layer` is used on stage 0 and `head_layer` on stage S-1 (either
    may be None elsewhere). The optimizer is built over this rank's
    parameters; it is wrapped in ``HybridParallelOptimizer`` (dp
    averaging, the hybrid clip) unless it is one already.

    ``step(ids, labels, *, segment_ids=None, position_ids=None)`` takes
    the GLOBAL batch ([M*mb, seq] numpy or tensors; the packed ids are
    keyword-only, microbatched like the labels and published to the
    blocks through ``parallel.segments``; VPP rejects them, as in JAX)
    and returns the step's loss. `remat` (a policy of
    ``scan_layers.REMAT_POLICIES``, True for "full", the JAX default)
    applies per block. `seed` is accepted (the JAX step's dropout key;
    the port's blocks draw no random numbers). The modules are the
    parameters, so ``sync_params_to_model`` and
    ``sync_states_to_optimizer`` (JAX names) have nothing to move.

    Elastic checkpoints: each stage rank captures its modules under the
    single model's canonical names (``checkpoint.elastic.
    capture_modules(named, step.optimizer, step.step_count)``), so a
    pipeline snapshot and a ``TrainStep`` one are the same snapshot; on
    resume ``elastic.restore(arrays, meta, module, optimizer,
    mapper=...)`` per stage module, before the step is built or into a
    built one, gives each parameter and this rank's optimizer its stage's
    values and moments by name (a ZeRO axis rank its slice), and sets
    the step count."""

    _replicate = False      # every data rank takes the whole batch (ZB-H1)

    def __init__(self, embed_layer, blocks, head_layer, loss_fn,
                 optimizer=None, mesh=None, num_micro: int = 1, remat=True,
                 seed: int = 0, virtual_pp: int = 1, zero_axis=None,
                 fp8_policy=None, dispatch_window: int | None = None):
        from paddle_tpu_torch.distributed.mesh import get_mesh
        from paddle_tpu_torch.io.device_feed import DispatchWindow

        check_unported(fp8_policy)
        mesh = mesh if mesh is not None else get_mesh()
        if mesh is None or "pp" not in mesh.shape:
            raise ValueError("PipelinedTrainStep requires a mesh with a "
                             "'pp' axis")
        self.zero_axis = pipeline_zero_axis(mesh, zero_axis, virtual_pp,
                                            data_axis=not self._replicate)
        self.remat_policy = normalize_remat(remat)
        if self.zero_axis is not None and not self._replicate \
                and self.remat_policy not in ("none", "full"):
            raise ValueError(
                f"zero_axis: the ZeRO-3 block loop re-gathers and "
                f"recomputes each block in backward (its own 'full'-grade "
                f"schedule); remat policy {self.remat_policy!r} cannot "
                f"apply to the sharded stack")
        self.mesh = mesh
        self.hcg, strategy = pipeline_hcg(mesh, self.zero_axis)
        self.S = self.hcg.get_pipe_parallel_world_size()
        self.V = int(virtual_pp)
        self.M = int(num_micro)
        self.stage = self.hcg.get_stage_id()
        blocks = list(blocks)
        if len(blocks) % self.V:
            raise ValueError(f"{len(blocks)} local blocks do not split into "
                             f"virtual_pp={self.V} chunks")
        bpc = len(blocks) // self.V
        self.embed, self.blocks, self.head = embed_layer, blocks, head_layer
        self.loss_fn = loss_fn
        parts = []
        for c in range(self.V):
            p = c * self.S + self.stage
            first, last = p == 0, p == self.S * self.V - 1
            if first and embed_layer is None:
                raise ValueError("stage 0 needs the embedding layer")
            if last and head_layer is None:
                raise ValueError("the last stage needs the head layer")
            mine = blocks[c * bpc:(c + 1) * bpc]
            fns = ([embed_layer] if first else []) + mine \
                + ([head_layer] if last else [])
            marks = ([False] if first else []) + [True] * len(mine) \
                + ([False] if last else [])
            parts.append(StagePart(p, fns, marks, first, last))
        self.engine = PipelineEngine(parts, loss_fn, self.hcg, self.M,
                                     self.remat_policy,
                                     replicate=self._replicate)
        self._modules = [m for part in parts for m in part.fns]
        sync_replicas(self._modules, self.hcg)
        self.sharder = None
        if self.zero_axis is not None:
            from paddle_tpu_torch.parallel.scan_layers import ScanShardInfo

            self.sharder = shard_stage_blocks(blocks, self.hcg,
                                              loop=not self._replicate)
            if not self._replicate:
                self.engine.zero = ScanShardInfo(self.sharder, "ahead")
        if optimizer is not None and not hasattr(optimizer,
                                                 "last_grad_norm"):
            from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
                hybrid_parallel_optimizer import HybridParallelOptimizer

            optimizer = HybridParallelOptimizer(optimizer, self.hcg,
                                                strategy)
        self.optimizer = optimizer
        self._window = DispatchWindow(dispatch_window)
        self._last_event = None

    def _forward_backward(self, ids, labels, extras):
        return self.engine.forward_backward(ids, labels, extras)

    def _run(self, ids, labels, segment_ids, position_ids):
        """One step's forward and backward from cleared gradients; the
        gradients are left in ``.grad``."""
        extras = {k: v for k, v in (("segment_ids", segment_ids),
                                    ("position_ids", position_ids))
                  if v is not None}
        if extras and self.V > 1:
            raise ValueError(
                "interleaved virtual-pp does not support packed-batch "
                "segment/position ids yet; use virtual_pp=1 (1F1B)")
        for m in self._modules:
            m.train()
        if self.optimizer is not None:
            self.optimizer.clear_grad()
        for m in self._modules:
            m.zero_grad(set_to_none=True)
        return self._forward_backward(ids, labels, extras)

    def __call__(self, ids, labels, *, segment_ids=None, position_ids=None):
        from paddle_tpu_torch.io.device_feed import step_event

        loss = self._run(ids, labels, segment_ids, position_ids)
        if self.optimizer is not None:
            self.optimizer.step()
        self._last_event = step_event(self.engine.device)
        self._window.admit(self._last_event)
        return loss.detach()

    def step_async(self, ids, labels, *, segment_ids=None,
                   position_ids=None):
        """Run one step and return a ``LossFuture``."""
        from paddle_tpu_torch.io.device_feed import LossFuture

        loss = self(ids, labels, segment_ids=segment_ids,
                    position_ids=position_ids)
        return LossFuture(loss, self._last_event)

    def drain(self):
        """Wait until every step run so far has finished on the device."""
        self._window.drain()

    @property
    def last_grad_norm(self):
        """The hybrid global norm of the last step's gradients."""
        opt = self.optimizer
        return None if opt is None else opt.last_grad_norm

    @property
    def step_count(self) -> int:
        """The optimizer's step count."""
        if self.optimizer is None:
            return 0
        from paddle_tpu_torch.distributed.checkpoint.elastic import (
            innermost_opt)

        return int(innermost_opt(self.optimizer)[0]._step_count)

    def sync_params_to_model(self):
        """The stage modules hold the trained parameters themselves."""

    def sync_states_to_optimizer(self):
        """The optimizer holds its states itself."""


def pipeline_zero_axis(mesh, zero_axis, virtual_pp=1, data_axis=True):
    """The zero axis a pipeline shards its blocks over, or None (JAX
    ``pipeline.py:236-256``): an axis the mesh lacks warns and leaves ZeRO
    off; under VPP, and (with `data_axis`) for an axis the batch rows do
    not split over, it raises."""
    import warnings

    if zero_axis is None:
        return None
    if zero_axis not in mesh.shape:
        warnings.warn(f"zero_axis={zero_axis!r} is not a mesh axis "
                      f"({tuple(mesh.shape)}); per-stage ZeRO sharding is "
                      f"OFF")
        return None
    if mesh.shape[zero_axis] <= 1:
        return None
    if int(virtual_pp) > 1:
        raise ValueError("zero_axis sharding is not supported with "
                         "interleaved virtual_pp yet; use virtual_pp=1 "
                         "(1F1B)")
    data = tuple(a for a in ("dp", "sharding") if mesh.shape.get(a, 1) > 1)
    if data_axis and zero_axis not in data:
        # the reduce-scatter sums the shard ranks' gradients: right only
        # when the batch splits over the axis
        raise ValueError(f"zero_axis={zero_axis!r} must be a data axis the "
                         f"batch shards over ({data or 'none in this mesh'})")
    return zero_axis


def shard_stage_blocks(blocks, hcg, loop=True):
    """A ``ParamSharder`` over the sharding group whose units are the
    stage's `blocks` (loop units, or held units for ZB-H1); block i's
    parameters are named ``"block<i>.<name>"``."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        ParamSharder)

    sharder = ParamSharder(hcg.get_sharding_parallel_group())
    for i, b in enumerate(blocks):
        sharder.add_unit(f"block{i}", b, [(f"block{i}.{n}", p) for n, p in
                                          b.named_parameters()], loop=loop)
    return sharder


def stage_block_indices(n_blocks: int, S: int, stage: int, V: int = 1):
    """The model's block indices pp rank `stage` holds, in chunk order
    (chunk c: blocks [(c*S + stage)*bpc, (c*S + stage + 1)*bpc))."""
    if n_blocks % (S * V):
        raise ValueError(f"{n_blocks} blocks not divisible by "
                         f"pp*virtual_pp={S * V}")
    bpc = n_blocks // (S * V)
    return [(c * S + stage) * bpc + i for c in range(V) for i in range(bpc)]

