"""Elastic training checkpoints (``paddle_tpu.distributed.checkpoint.
elastic`` counterpart): capture without blocking the step, a
crash-consistent commit, and resume under another parallel layout.

**Capture.** ``capture(step)`` takes a ``TrainStep``'s training state
(``named_train_state``: parameters, optimizer moments, fp8 amax
histories, the GradScaler's scalars, the step count, the JAX package's
RNG key when a snapshot carried one, and the caller's data cursor) and
CLONES every tensor on the current stream. The port's optimizer updates
the parameters in place, so the clones are what is saved: the caller
returns at once and the next step may overwrite the originals. An event
recorded after the clones is what the writer thread waits on before it
copies them to the host, on a side stream of its own, off the step's
critical path. The writer (``paddle_tpu_torch.ckpt.writer``: a bounded
queue, joined on ``close``) also does the file I/O.

**Crash-consistent commit.** Shard containers land under
``tmp/step_N/`` and are fsync'd; the coordinator merges their shard
tables into the global metadata, renames the directory into place and
only then writes the ``COMMIT`` marker (after a ``TCPStore`` barrier when
several ranks save). ``latest()`` resolves committed snapshots only, so a
kill at any point (mid shard write, before the rename, between the rename
and the marker) leaves the previous committed snapshot loadable. Keep-last-K
GC runs after each commit. Every phase boundary is a ``ckpt.*`` point of
the fault registry (``FAULT_POINTS``; ``FLAGS_ckpt_fault_injection`` arms
them too).

**Resume across layouts.** A snapshot holds the JAX package's
layout-free NAMES (``model/<state-dict name>``, ``opt/<name>/<slot>``,
``fp8/<i>``) and layout: each rank writes what it holds at its true global
offset (``save_state_dict``), replicated values once, linear weights of
the PyTorch-layout models transposed to the JAX package's ``[in, out]``
(``layout``). ``CheckpointManager.load`` reconstructs full arrays, and
``restore`` cuts each parameter's and moment's part for the target (its
mp shard, ZeRO-3 range or ZeRO-1/2 slice) BEFORE the step is built (or
into a built one), so a dp 2 save resumes at dp 1, ZeRO-3 resumes
replicated, mp 2 resumes at mp 1, a pipeline's stages (``capture_modules``
under canonical names) resume into ``TrainStep`` and back, and a JAX
``CompiledTrainStep`` snapshot resumes in the port.

Preemption: ``install_preemption_handler`` (SIGTERM -> save and stop, with
the watchdog's diagnostic dump) and ``install_hang_handler`` (a
``watchdog.CommTaskManager`` hang runs the same path, dump first).
"""
from __future__ import annotations

import glob
import json
import os
import queue
import shutil
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from paddle_tpu_torch.distributed.checkpoint import layout
from paddle_tpu_torch.distributed.checkpoint.format import dtype_name
from paddle_tpu_torch.distributed.checkpoint.save_state_dict import (
    LocalShards, range_boxes)
from paddle_tpu_torch.distributed.resilience import faults

__all__ = [
    "FAULT_POINTS", "CheckpointFaultInjected", "Snapshot", "capture",
    "capture_model", "capture_modules", "restore", "rename_arrays",
    "CheckpointManager", "install_preemption_handler",
    "install_hang_handler", "module_state", "innermost_opt",
]

FAULT_POINTS = ("after_snapshot", "after_shard_write", "after_metadata",
                "before_rename", "before_commit", "after_commit")

WRITER_THREAD = "paddle_tpu_torch.ckpt.writer"

_STATE_JSON = "state.json"
_COMMIT = "COMMIT"
_TMP = "tmp"


class CheckpointFaultInjected(faults.FaultInjected):
    """Raised at an armed ckpt.* fault point: the stand-in for a kill -9 at
    that phase of the commit protocol. Armed through the fault registry
    or the legacy FLAGS_ckpt_fault_injection flag."""


_PHASE_DOCS = {
    "after_snapshot": "after the donation-safe device copies, before any "
                      "readback/IO",
    "after_shard_write": "shard container written+fsync'd, before the "
                         "written barrier",
    "after_metadata": "global metadata merged and written, before the "
                      "publish rename",
    "before_rename": "the last instant the snapshot is still invisible",
    "before_commit": "renamed into place but no COMMIT marker yet",
    "after_commit": "committed; GC has not run",
}
for _p in FAULT_POINTS:
    faults.register(f"ckpt.{_p}",
                    f"elastic-checkpoint commit protocol: {_PHASE_DOCS[_p]}",
                    exc=CheckpointFaultInjected,
                    legacy_flag=("ckpt_fault_injection", _p))


def _maybe_inject(point: str):
    faults.point(f"ckpt.{point}")


def _step_dirname(step: int) -> str:
    return f"step_{int(step):08d}"


def _parse_step(name: str):
    if not name.startswith("step_"):
        return None
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


# -- the training state under layout-free names ------------------------------
def innermost_opt(optimizer):
    """(base optimizer, ZeRO sharding optimizer or None) of an optimizer
    possibly wrapped in ``HybridParallelOptimizer``/
    ``DygraphShardingOptimizer``/``LookAhead``: the base one holds
    ``_state`` (keyed by parameter index) and ``_step_count``."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
        dygraph_sharding_optimizer import DygraphShardingOptimizer

    opt, dso = optimizer, None
    while True:
        if isinstance(opt, DygraphShardingOptimizer):
            dso = opt
        inner = opt.__dict__.get("_inner_opt",
                                 opt.__dict__.get("inner_optimizer"))
        if inner is None or inner is opt:
            return opt, dso
        opt = inner


def _state_items(module):
    """[(name, tensor)] of a module's state (parameters and persistent
    buffers): a torch module's own tensors, a Paddle-API layer's values."""
    if isinstance(module, torch.nn.Module):
        return list(module.state_dict(keep_vars=True).items())
    return [(n, t._value) for n, t in module.state_dict().items()]


def _entry(value, p, c, extra, trans, rng=None):
    """``LocalShards`` of `value`: parameter `p`'s local tensor, or (with
    `rng` = (a, e)) elements [a, e) of it as a 1-D tensor."""
    shape, gshape, base, split = layout.placement(p, c)
    split = split | extra
    boxes = []
    if layout.writes(split, c):
        if rng is None:
            boxes = [(base, value.reshape(shape))]
        else:
            a, e = rng
            flat = value.reshape(-1)
            for off, bshape, fs in range_boxes(a, e, shape):
                n = int(np.prod(bshape))
                boxes.append((tuple(b + o for b, o in zip(base, off)),
                              flat[fs - a:fs - a + n].view(bshape)))
    if trans and len(gshape) == 2:
        boxes = [((o[1], o[0]), t.t()) for o, t in boxes]
        gshape = gshape[::-1]
    return LocalShards(boxes, gshape, dtype_name(value))


def _whole(value, split, c):
    """A value every holder keeps whole (a scalar state, a buffer)."""
    boxes = ([((0,) * value.dim(), value)] if layout.writes(split, c)
             else [])
    return LocalShards(boxes, tuple(value.shape), dtype_name(value))


def module_state(named_modules: dict, optimizer=None, extra=()):
    """({"model/<prefix><name>": LocalShards, "opt/<name>/<slot>": ...},
    the base optimizer's step count) of the modules `named_modules`
    ({canonical prefix: module}) and `optimizer` over their parameters.
    `extra`: mesh axes the modules' values differ along besides their own
    marks ("pp" for pipeline stages)."""
    c = layout.coords()
    extra = set(extra)
    arrays, names = {}, {}
    for prefix, module in named_modules.items():
        plain = layout.unwrap(module)
        params = ({id(p) for p in plain.parameters()}
                  if isinstance(plain, torch.nn.Module) else None)
        for name, t in _state_items(plain):
            cname = f"{prefix}{name}"
            if params is not None and id(t) not in params:
                # a buffer: replicated wherever the module is
                arrays[f"model/{cname}"] = _whole(t.detach(), extra, c)
                continue
            trans = layout.jax_transposed(plain, cname)
            names[id(t)] = (cname, trans)
            arrays[f"model/{cname}"] = _entry(
                layout.storage(t).detach(), t, c, extra, trans,
                layout.zero3_range(t))
    count = 0
    if optimizer is not None:
        base, dso = innermost_opt(optimizer)
        count = int(getattr(base, "_step_count", 0) or 0)
        params = dso._full if dso is not None else base._params
        for i, p in enumerate(params):
            hit = names.get(id(p))
            st = base._state.get(i)
            if hit is None or not st:
                continue
            cname, trans = hit
            shape = layout.placement(p, c)[0]
            numel = int(np.prod(shape))
            rng, split = layout.zero3_range(p), set(extra)
            if dso is not None and not dso._z3[i]:
                per, r = dso._per[i], dso._group.rank
                rng = (min(r * per, numel), min(r * per + per, numel))
                split.add("sharding")
            want = numel if rng is None else rng[1] - rng[0]
            for k, v in st.items():
                v = v.detach()
                if dso is not None and not dso._z3[i] and v.dim() == 1 \
                        and v.numel() == per:
                    v = v[:want]
                if v.numel() != want or v.dim() == 0:
                    arrays[f"opt/{cname}/{k}"] = _whole(
                        v, layout.placement(p, c)[3] | split, c)
                    continue
                arrays[f"opt/{cname}/{k}"] = _entry(v, p, c, split, trans,
                                                    rng)
    return arrays, count


def _copy(v):
    """A copy that the training step cannot overwrite: tensors cloned
    (contiguous) on the current stream, other values as numpy."""
    if isinstance(v, LocalShards):
        return v.map(_copy)
    if isinstance(v, torch.Tensor):
        return v.detach().clone(memory_format=torch.contiguous_format)
    return np.array(v, copy=True)


def _device_of(arrays):
    for v in arrays.values():
        ts = ([t for _, t in v.boxes] if isinstance(v, LocalShards)
              else [v])
        for t in ts:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                return t.device
    return None


@dataclass
class Snapshot:
    """One capture: `arrays` name -> cloned tensor, ``LocalShards`` or
    numpy array; `meta` a JSON-able dict (step, fp8 layout, scaler, cursor,
    diagnostics). `event` marks the clones' completion on the device
    (None on the CPU); `capture_ms` is the caller thread's time in the
    capture."""

    step: int
    arrays: dict
    meta: dict = field(default_factory=dict)
    event: object = None
    capture_ms: float = 0.0


def _snapshot(step, arrays, meta, t0):
    copies = {k: _copy(v) for k, v in arrays.items()}
    dev = _device_of(copies)
    event = None
    if dev is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    return Snapshot(step=int(step), arrays=copies, meta=meta, event=event,
                    capture_ms=(time.perf_counter() - t0) * 1e3)


def capture(step, cursor=None) -> Snapshot:
    """Snapshot a ``TrainStep`` without waiting for the device: its
    ``named_train_state()`` cloned on the current stream. `cursor` is the
    caller's data position (e.g. ``DeviceFeeder.batches_consumed``) and
    rides in meta."""
    t0 = time.perf_counter()
    arrays, meta = step.named_train_state()
    if cursor is not None:
        meta["cursor"] = cursor
    return _snapshot(step.step_count, arrays, meta, t0)


def capture_model(network, optimizer=None, step=None, cursor=None) -> Snapshot:
    """Capture a model (+ the optimizer's moments keyed by parameter name)
    without a step object; `step` defaults to the optimizer's count."""
    return capture_modules({"": network}, optimizer, step, cursor)


def capture_modules(named_modules: dict, optimizer=None, step=None,
                    cursor=None) -> Snapshot:
    """Capture a multi-module topology (pipeline stages) under canonical
    names: `named_modules` maps a canonical prefix to a module, e.g.
    ``{"llama.": embed_stage, "llama.layers.0.": block0, ...,
    "llama.norm.": head.norm, "lm_head.": head.lm_head}``, so the snapshot
    resumes interchangeably with a ``capture()`` one (pp on <-> off). Under
    a pipeline hcg each stage rank writes its own modules."""
    t0 = time.perf_counter()
    c = layout.coords()
    extra = ("pp",) if c.get("pp", (0, 1))[1] > 1 else ()
    arrays, count = module_state(named_modules, optimizer, extra)
    step = int(count if step is None else step)
    meta: dict = {"step": step}
    if cursor is not None:
        meta["cursor"] = cursor
    return _snapshot(step, arrays, meta, t0)


def rename_arrays(arrays: dict, mapper) -> dict:
    """Re-key a loaded snapshot's arrays. `mapper` is a callable
    ``name -> new_name | None`` (None drops the entry) or a dict of
    ``old_prefix -> new_prefix`` (longest matching prefix wins): the
    cross-topology glue, e.g. mapping ``model/llama.layers.3.`` onto a
    pipeline block's local names."""
    if isinstance(mapper, dict):
        prefixes = sorted(mapper, key=len, reverse=True)

        def fn(name):
            for p in prefixes:
                if name.startswith(p):
                    return mapper[p] + name[len(p):]
            return None
    else:
        fn = mapper
    out = {}
    for name, v in arrays.items():
        new = fn(name)
        if new is not None:
            out[new] = v
    return out


def _full(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v, copy=True))


@torch.no_grad()
def restore(arrays: dict, meta: dict, model, optimizer=None, mapper=None):
    """Load a snapshot (``CheckpointManager.load``'s full arrays) into
    `model` and, with `optimizer`, its moments and step count. Call it
    before building the train step (the step shards the restored values
    for its layout) or on a built one: each parameter takes its part of
    the global array (mp shard, expert block, ZeRO-3 range) and each
    moment its part (a ZeRO-1/2 slice included). Entries the model does
    not own are ignored, so pipeline stages restore by calling this once
    per module with a `mapper` (see ``rename_arrays``). Returns (missing,
    unexpected): the model's names the snapshot lacks, and [] (entries of
    other modules are not an error)."""
    origin = {k: k for k in arrays}
    if mapper is not None:
        arrays = rename_arrays(arrays, mapper)
        origin = rename_arrays(origin, mapper)
    plain = layout.unwrap(model)
    c = layout.coords()

    def tr(key):
        # the canonical (saved) name or the module's own says "linear"
        names = (key, origin[key])
        if key.startswith("opt/"):
            names = tuple(n.rsplit("/", 1)[0] for n in names)
        return any(layout.jax_transposed(plain, n) for n in names)

    own = _state_items(plain)
    names, missing = {}, []
    for name, t in own:
        names[id(t)] = name
        v = arrays.get(f"model/{name}")
        if v is None:
            missing.append(name)
            continue
        dst = layout.storage(t)
        full = _full(v).to(dst.device)    # transposes and cuts there
        if tr(f"model/{name}") and full.dim() == 2:
            full = full.t()
        dst.copy_(layout.local_part(full, t, c).reshape(dst.shape)
                  .to(dtype=dst.dtype))
    if optimizer is not None:
        base, dso = innermost_opt(optimizer)
        slots: dict = {}
        for name, v in arrays.items():
            if name.startswith("opt/"):
                pname, slot = name[len("opt/"):].rsplit("/", 1)
                slots.setdefault(pname, {})[slot] = (v, tr(name))
        params = dso._full if dso is not None else base._params
        for i, p in enumerate(params):
            pname = names.get(id(p))
            saved = slots.get(pname)
            if saved is None:
                continue
            target = dso._slices[i] if dso is not None else p
            st = base._init_state(target)
            gshape = layout.placement(p, c)[1]
            for k, (v, trans) in saved.items():
                if k not in st:
                    continue
                full = _full(v).to(st[k].device)
                if trans and full.dim() == 2:
                    full = full.t()
                if tuple(full.shape) != gshape:
                    # a state that is not per element (a scalar)
                    st[k].copy_(full.reshape(st[k].shape).to(st[k].dtype))
                    continue
                part = layout.local_part(full, p, c).reshape(-1)
                if dso is not None and not dso._z3[i]:
                    per, r = dso._per[i], dso._group.rank
                    part = part[r * per:(r + 1) * per]
                    st[k].zero_()
                    st[k].reshape(-1)[:part.numel()].copy_(part)
                else:
                    st[k].copy_(part.reshape(st[k].shape).to(st[k].dtype))
            base._state[i] = st
        base._step_count = int(meta.get("step", 0))
    return missing, []


# -- the commit protocol ------------------------------------------------------
class _SaveHandle:
    """Completion handle for one async save: `wait()` blocks until the
    writer finished this snapshot (re-raising its error, fault injections
    included)."""

    __slots__ = ("step", "_done", "_err")

    def __init__(self, step):
        self.step = step
        self._done = threading.Event()
        self._err = None

    def done(self) -> bool:
        return self._done.is_set()

    def error(self):
        """The writer's exception for this snapshot (None while in flight
        or on success): the non-blocking probe a supervisor reaps failed
        saves with."""
        return self._err if self._done.is_set() else None

    def wait(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"checkpoint save of step {self.step} "
                               f"still in flight")
        if self._err is not None:
            raise self._err
        return self


def _default_store(world):
    """A client of the parallel env's store for the barriers (its own
    connection, used from the writer thread), or None."""
    if world <= 1:
        return None
    from paddle_tpu_torch.distributed import parallel
    from paddle_tpu_torch.distributed.store import TCPStore

    s = parallel._STATE.get("store")
    if s is None:
        return None
    return TCPStore(s.host, s.port, is_master=False)


class CheckpointManager:
    """Commit-protocol checkpoint directory + async writer thread.

    ``root/step_NNNNNNNN/`` holds committed snapshots (shard containers +
    JSON metadata + ``state.json`` + ``COMMIT``); ``root/tmp/`` holds
    in-progress writes. ``latest()``/``load()`` see only committed steps;
    ``save``/``save_async`` run the crash-consistent protocol (the module
    docstring). `store`/`world_size`/`rank` wire the multi-rank barrier
    (by default the ranks of the parallel env, over a client of its
    store); every rank saves into the same `root`. ``timings`` keeps one
    record a save: host copy, write, fsync and commit seconds, bytes."""

    def __init__(self, root: str, keep_last: int | None = None,
                 store=None, world_size: int | None = None,
                 rank: int | None = None, coordinator_rank: int = 0,
                 job_id: str = "ckpt"):
        from paddle_tpu_torch.core.flags import flag
        from paddle_tpu_torch.distributed.env import get_rank, get_world_size

        self.root = str(root)
        self.keep_last = int(flag("ckpt_keep_last")
                             if keep_last is None else keep_last)
        self.world = int(get_world_size() if world_size is None
                         else world_size)
        self.rank = int(get_rank() if rank is None else rank)
        self._own_store = store is None
        self.store = store if store is not None else _default_store(
            self.world)
        self.coordinator_rank = int(coordinator_rank)
        self.job_id = job_id
        os.makedirs(self.root, exist_ok=True)
        self.preempt_reason: str | None = None
        self.timings: list[dict] = []
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._thread: threading.Thread | None = None
        self._closing = False
        self._handles: list[_SaveHandle] = []
        self._lock = threading.Lock()
        # serializes _write_snapshot between the writer thread and SYNC
        # saves (SIGTERM/hang handlers); `writing_in_this_thread` lets a
        # signal handler see that it interrupted a save on its own thread
        self._write_lock = threading.Lock()
        self._write_tls = threading.local()
        self._last_save_id = None
        self._stream = None

    # -- resolution ----------------------------------------------------------
    def _is_committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(self.root, _step_dirname(step),
                                           _COMMIT))

    def steps(self) -> list:
        """All COMMITTED snapshot steps, ascending."""
        out = []
        for name in os.listdir(self.root):
            step = _parse_step(name)
            if step is not None and self._is_committed(step):
                out.append(step)
        return sorted(out)

    def latest(self):
        """Newest committed step, or None. Uncommitted directories (a crash
        between rename and COMMIT) are invisible here."""
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.root, _step_dirname(step))

    def load(self, step: int | None = None):
        """(arrays, meta) of a committed snapshot (default: latest). Arrays
        come back as full CPU tensors whatever layout they were saved
        under (``read_global_state``)."""
        from paddle_tpu_torch.distributed.checkpoint.load_state_dict import (
            read_global_state)

        if step is None:
            step = self.latest()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.root!r}")
        if not self._is_committed(step):
            raise FileNotFoundError(
                f"step {step} has no COMMIT marker under {self.root!r} "
                f"(crashed save?); latest committed is {self.latest()}")
        path = self.path(step)
        with open(os.path.join(path, _STATE_JSON)) as f:
            meta = json.load(f)
        return read_global_state(path), meta

    # -- preemption ----------------------------------------------------------
    def request_preempt(self, reason: str):
        """Mark the job preempted (SIGTERM / watchdog hang); training loops
        poll `should_stop` and exit after the save."""
        self.preempt_reason = reason

    def clear_preempt(self):
        """Un-mark preemption (the supervisor's in-process restart after a
        hang: the snapshot the hang handler committed has been
        restored)."""
        self.preempt_reason = None

    @property
    def should_stop(self) -> bool:
        return self.preempt_reason is not None

    # -- write path ----------------------------------------------------------
    def save(self, snapshot: Snapshot) -> _SaveHandle:
        """Synchronous save: runs the full commit protocol on the calling
        thread (the SIGTERM path). Raises on failure, injected faults
        included, leaving the previous committed snapshot intact."""
        h = _SaveHandle(snapshot.step)
        try:
            self._write_snapshot(snapshot)
        except BaseException as e:
            h._err = e
            raise
        finally:
            h._done.set()
        return h

    def save_async(self, snapshot: Snapshot) -> _SaveHandle:
        """Enqueue a snapshot for the writer thread; returns at once
        (bounded queue: blocks only when 2 saves are in flight). Errors
        surface on the handle and on `wait()`."""
        self._ensure_thread()
        h = _SaveHandle(snapshot.step)
        with self._lock:
            self._handles.append(h)
        self._q.put((snapshot, h))
        return h

    def wait(self):
        """Block until every queued save finished; re-raise the first
        failure (fault injections included)."""
        with self._lock:
            handles, self._handles = self._handles, []
        err = None
        for h in handles:
            h._done.wait()
            if err is None and h._err is not None:
                err = h._err
        if err is not None:
            raise err

    def close(self, timeout: float = 60.0):
        """Finish queued saves, stop and JOIN the writer thread. Idempotent;
        errors already surfaced through handles are not re-raised. A writer
        still busy after `timeout` is not detached: a warning fires and a
        later close() finishes the join."""
        if self._thread is not None:
            if not self._closing:
                self._closing = True
                self._q.put(None)
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                import warnings

                warnings.warn(
                    f"checkpoint writer still busy after {timeout:.0f}s "
                    f"(large snapshot / slow storage?); not detaching - "
                    f"call close() again to finish joining")
                return
            self._thread = None
            self._closing = False
        if self._own_store and self.store is not None:
            self.store.close()
            self.store = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False

    def _ensure_thread(self):
        if self._closing:
            raise RuntimeError(
                "CheckpointManager is closing (writer still draining); "
                "call close() to completion before saving again")
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True, name=WRITER_THREAD)
            self._thread.start()

    def _writer_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            snapshot, handle = item
            try:
                self._write_snapshot(snapshot)
            except BaseException as e:
                handle._err = e
            finally:
                handle._done.set()

    def _save_id(self, step: int):
        """This save's barrier namespace: the root, the rank's count of
        saves into it (kept in the store, so every rank's n-th save of
        the job meets the others' n-th, whatever manager object made it)
        and the step. None without a multi-rank store."""
        if self.store is None or self.world <= 1:
            return None
        root = os.path.abspath(self.root)
        n = self.store.add(f"__ckpt_seq__/{self.job_id}/{root}/{self.rank}",
                           1)
        return f"{self.job_id}/{root}/{n}/{step}"

    def _barrier(self, tag: str, save_id):
        if save_id is not None:
            self.store.barrier(f"{save_id}/{tag}", self.world,
                               rank=self.rank)

    def _cleanup_barriers(self, save_id):
        """Delete the PREVIOUS save's barrier keys (coordinator): by the
        time save N runs every rank has left save N-1's barriers."""
        for tag in ("written", "committed"):
            name = f"{save_id}/{tag}"
            self.store.delete_key(f"__barrier__/{name}")
            self.store.delete_key(f"__barrier_done__/{name}")
            for r in range(self.world):
                self.store.delete_key(f"__barrier_arrived__/{name}/{r}")

    @property
    def writing_in_this_thread(self) -> bool:
        """True while the CURRENT thread is inside the commit protocol (a
        preemption handler must not re-enter it)."""
        return bool(getattr(self._write_tls, "writing", False))

    def _write_snapshot(self, snapshot: Snapshot):
        """host copy -> tmp write -> fsync -> metadata -> rename -> COMMIT
        -> GC, with a ``ckpt.*`` fault point at every phase boundary."""
        if self.writing_in_this_thread:
            raise RuntimeError(
                "re-entrant checkpoint save on the same thread (signal "
                "handler during a sync save?) - the in-progress save "
                "already covers this state")
        from paddle_tpu_torch.observability import events as _events
        from paddle_tpu_torch.observability import tracing as _tracing

        with self._write_lock:
            self._write_tls.writing = True
            try:
                with _tracing.span("ckpt.commit", component="ckpt",
                                   step=int(snapshot.step)):
                    out = self._write_snapshot_locked(snapshot)
                _events.emit("ckpt", "commit", step=int(snapshot.step),
                             root=self.root)
                return out
            finally:
                self._write_tls.writing = False

    def _to_host(self, snapshot: Snapshot) -> dict:
        """The snapshot's tensors on the host: pinned copies that wait for
        the capture's event on a side stream (the step's stream runs on),
        then one synchronize of that stream."""
        ev = snapshot.event
        if ev is None:
            return dict(snapshot.arrays)
        dev = _device_of(snapshot.arrays)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)

        def host(t):
            if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
                return t
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h

        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ev)
            out = {k: (v.map(host) if isinstance(v, LocalShards)
                       else host(v)) for k, v in snapshot.arrays.items()}
        self._stream.synchronize()
        return out

    def _write_snapshot_locked(self, snapshot: Snapshot):
        from paddle_tpu_torch.distributed.checkpoint import (
            format as ckpt_format)
        from paddle_tpu_torch.distributed.checkpoint.metadata import (
            LocalTensorIndex, LocalTensorMetadata, Metadata)
        from paddle_tpu_torch.distributed.checkpoint.save_state_dict import (
            collect_shards, merge_metas)

        step = int(snapshot.step)
        rec = {"step": step, "capture_ms": snapshot.capture_ms}
        t_start = time.perf_counter()
        is_coord = self.rank == self.coordinator_rank
        save_id = self._save_id(step)
        if is_coord and self._last_save_id is not None:
            self._cleanup_barriers(self._last_save_id)
        self._last_save_id = save_id
        final_dir = self.path(step)
        tmp_dir = os.path.join(self.root, _TMP, _step_dirname(step))
        if is_coord and os.path.isdir(final_dir):
            if self._is_committed(step):
                raise FileExistsError(
                    f"step {step} is already committed under {self.root!r}")
            shutil.rmtree(final_dir)  # uncommitted leftover of a crash
        os.makedirs(tmp_dir, exist_ok=True)

        # phase 0: the device->host copies of the snapshot's clones
        _maybe_inject("after_snapshot")
        t0 = time.perf_counter()
        _, data = collect_shards(self._to_host(snapshot), "")
        rec["host_s"] = time.perf_counter() - t0

        # phase 1: shard containers, fsync'd before anything references
        # them
        ckpt_format.write_rank_files(tmp_dir, self.rank, data, timings=rec)
        ckpt_format.fsync_dir(tmp_dir)
        _maybe_inject("after_shard_write")
        self._barrier("written", save_id)

        # phase 2 (coordinator): the global metadata view is merged from
        # the shard tables ON DISK, so it never describes bytes that did
        # not land
        t0 = time.perf_counter()
        if is_coord:
            metas = []
            for f in sorted(glob.glob(os.path.join(tmp_dir, "*.distcp"))):
                m = Metadata()
                for ent in ckpt_format.shard_table(f):
                    off = tuple(int(o) for o in ent["offset"])
                    m.state_dict_metadata.setdefault(
                        ent["key"], []).append(LocalTensorMetadata(
                            off, tuple(ent["shape"]), ent["dtype"]))
                    m.storage_metadata[LocalTensorIndex(ent["key"], off)] = (
                        os.path.basename(f))
                metas.append(m)
            ckpt_format.write_metadata(
                os.path.join(tmp_dir, "0.metadata"), merge_metas(metas))
            doc = dict(snapshot.meta)
            doc["step"] = step
            with open(os.path.join(tmp_dir, _STATE_JSON), "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            ckpt_format.fsync_dir(tmp_dir)
        _maybe_inject("after_metadata")

        # phase 3 (coordinator): publish by rename (atomic on POSIX)
        _maybe_inject("before_rename")
        if is_coord:
            os.replace(tmp_dir, final_dir)
            ckpt_format.fsync_dir(self.root)
            # phase 4: the COMMIT marker makes it loadable; a kill between
            # rename and here leaves step_N invisible to latest()
            _maybe_inject("before_commit")
            with open(os.path.join(final_dir, _COMMIT), "w") as f:
                json.dump({"step": step, "format": ckpt_format.FORMAT_NAME},
                          f)
                f.flush()
                os.fsync(f.fileno())
            ckpt_format.fsync_dir(final_dir)
        self._barrier("committed", save_id)
        rec["commit_s"] = time.perf_counter() - t0
        _maybe_inject("after_commit")
        if is_coord:
            self._gc(step)
        rec["total_s"] = time.perf_counter() - t_start
        self.timings.append(rec)

    def _gc(self, just_committed: int):
        """Keep the last K committed snapshots; also clear stale tmp and
        uncommitted step dirs OLDER than the newest committed one."""
        committed = self.steps()
        if self.keep_last > 0:
            for step in committed[:-self.keep_last]:
                shutil.rmtree(self.path(step), ignore_errors=True)
        newest = committed[-1] if committed else just_committed
        for name in os.listdir(self.root):
            step = _parse_step(name)
            if (step is not None and step < newest
                    and not self._is_committed(step)):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        tmp_root = os.path.join(self.root, _TMP)
        if os.path.isdir(tmp_root):
            for name in os.listdir(tmp_root):
                step = _parse_step(name)
                if step is not None and step <= newest:
                    shutil.rmtree(os.path.join(tmp_root, name),
                                  ignore_errors=True)


def install_preemption_handler(manager: CheckpointManager,
                               capture_fn: Callable[[], Snapshot],
                               signals=(signal.SIGTERM,)) -> Callable[[], None]:
    """SIGTERM -> save and stop: run the commit protocol synchronously on
    `capture_fn()`'s snapshot, write the watchdog's diagnostic dump, and
    mark the manager preempted so training loops (`manager.should_stop`)
    wind down. Returns an uninstall callable. Call it from the main thread
    (CPython installs signal handlers there only)."""
    prev = {}

    def handler(signum, frame):
        manager.request_preempt(f"signal {signum}")
        from paddle_tpu_torch.distributed import watchdog

        state = watchdog.dump_state()
        if manager.writing_in_this_thread:
            # the signal interrupted a sync save on this thread: it
            # resumes and commits when the handler returns
            return
        snap = capture_fn()
        snap.meta = dict(snap.meta)
        snap.meta["preempt"] = {"signal": int(signum),
                                "in_flight": state["in_flight"]}
        try:
            manager.save(snap)
        except FileExistsError:
            pass  # this exact step is already committed: it IS durable

    for s in signals:
        prev[s] = signal.signal(s, handler)

    def uninstall():
        for s, h in prev.items():
            signal.signal(s, h)

    return uninstall


def install_hang_handler(manager: CheckpointManager,
                         capture_fn: Callable[[], Snapshot],
                         watchdog_manager=None) -> Callable[[], None]:
    """Wire a watchdog hang to save and stop: the listener receives the
    structured diagnostics, saves `capture_fn()` with them attached (best
    effort), then requests preemption. Returns the listener's uninstall
    callable."""
    from paddle_tpu_torch.distributed import watchdog

    def on_hang(task, diagnostics):
        try:
            snap = capture_fn()
            snap.meta = dict(snap.meta)
            snap.meta["hang"] = diagnostics
            try:
                manager.save(snap)
            except FileExistsError:
                pass  # this step is already durably committed
        finally:
            manager.request_preempt(f"hang: {task.name}")

    return watchdog.add_hang_listener(on_hang, manager=watchdog_manager)
