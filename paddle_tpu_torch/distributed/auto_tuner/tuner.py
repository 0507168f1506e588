"""The parallelism auto-tuner (``paddle_tpu.distributed.auto_tuner.tuner``
counterpart): a grid over {dp, mp, pp, sharding, micro-batches} with
pruning, trials that time real steps, and the fastest kept.

``candidate_configs``, ``prune_candidates`` and ``AutoTuner.search`` are
the JAX package's: the same candidates in the same order (ZB-H1 only for
pure pp). ``compiled_trial_fn`` runs each candidate INSIDE the world that
is already up, as the JAX package runs it inside its process: every rank
builds the candidate's rank mesh (kept and reused for a later candidate
of the same axes, so no trial makes c10d groups twice), its model and
its step (``PipelinedTrainStep``/``ZBH1PipelinedStep`` with pp > 1, each
rank holding its stage's blocks, else ``TrainStep``), times the steps,
and puts the previous mesh and hcg back.

The ranks run ``search`` in lockstep and agree at each of a trial's
three votes (after the build, after the warm-up steps, after the timed
steps; an all-reduce of a failure flag over the world): a failure on one
rank fails the trial on all, with every rank's message in the
candidate's ``error``; the trial's time is the slowest rank's. So the
history and the best are the same on every rank. A rank that raises
where the others wait in a collective of the step (a fault inside a
step, not in building it) leaves them waiting until the process group's
timeout.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

__all__ = ["AutoTuner", "TunerConfig", "prune_candidates",
           "candidate_configs", "compiled_trial_fn"]


@dataclass
class TunerConfig:
    dp: int = 1
    mp: int = 1
    pp: int = 1
    sharding: int = 1
    micro_batches: int = 1
    schedule_mode: str = "1F1B"
    time_s: float | None = None
    error: str | None = None

    @property
    def degree(self):
        return self.dp * self.mp * self.pp * self.sharding

    def as_axes(self):
        return {"dp": self.dp, "mp": self.mp, "pp": self.pp,
                "sharding": self.sharding}


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def candidate_configs(n_devices: int, max_micro: int = 8):
    out = []
    for pp in _divisors(n_devices):
        for mp in _divisors(n_devices // pp):
            rem = n_devices // (pp * mp)
            for sharding in _divisors(rem):
                dp = rem // sharding
                for mb in [m for m in (1, 2, 4, 8) if m <= max_micro]:
                    if pp == 1 and mb > 1:
                        continue
                    out.append(TunerConfig(dp=dp, mp=mp, pp=pp,
                                           sharding=sharding,
                                           micro_batches=mb))
                    # ZB-H1 is a pp-only schedule: offered only where it
                    # runs, so duplicates never crowd out distinct configs
                    if pp > 1 and mp == 1 and dp == 1 and sharding == 1 \
                            and mb > 1:
                        out.append(TunerConfig(
                            dp=dp, mp=mp, pp=pp, sharding=sharding,
                            micro_batches=mb, schedule_mode="ZB-H1"))
    return out


def prune_candidates(cands, *, n_layers=None, n_heads=None,
                     global_batch=None, param_bytes=None, hbm_bytes=None,
                     opt_state_mult=3.0):
    """Divisibility and memory pruning."""
    keep = []
    for c in cands:
        if n_layers is not None and n_layers % c.pp != 0:
            continue
        if n_heads is not None and n_heads % c.mp != 0:
            continue
        if global_batch is not None:
            shards = c.dp * c.sharding * c.micro_batches
            if global_batch % shards != 0:
                continue
        if param_bytes is not None and hbm_bytes is not None:
            per_chip = (param_bytes
                        * (1 + opt_state_mult / max(c.dp * c.sharding, 1))
                        / max(c.mp * c.pp, 1))
            if per_chip > hbm_bytes * 0.9:
                continue
        keep.append(c)
    return keep


class AutoTuner:
    """``run_trial(config) -> seconds a step``; a trial that raises is
    pruned at run time."""

    def __init__(self, n_devices: int,
                 run_trial: Callable[[TunerConfig], float],
                 prune_kwargs: dict | None = None, max_trials: int = 16):
        self.n_devices = n_devices
        self.run_trial = run_trial
        self.prune_kwargs = prune_kwargs or {}
        self.max_trials = max_trials
        self.history: list[TunerConfig] = []

    def search(self) -> TunerConfig:
        cands = prune_candidates(candidate_configs(self.n_devices),
                                 **self.prune_kwargs)
        best = None
        for c in cands[: self.max_trials]:
            try:
                t = self.run_trial(c)
                c.time_s = t
            except Exception as e:  # failed trial = pruned at runtime
                c.error = str(e)[:200]
                self.history.append(c)
                continue
            self.history.append(c)
            if best is None or (c.time_s is not None
                                and c.time_s < best.time_s):
                best = c
        if best is None:
            raise RuntimeError("auto-tuner: every candidate failed")
        return best


class TrialFailed(RuntimeError):
    """A trial failed on at least one rank (every rank raises it)."""


def _agree(failed: bool, seconds: float = 0.0):
    """(any rank failed, the largest seconds) over the world."""
    import torch

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.env import get_world_size

    if get_world_size() == 1:
        return failed, seconds
    dev = (torch.device("cuda", torch.cuda.current_device())
           if collective.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([1.0 if failed else 0.0, float(seconds)],
                     dtype=torch.float64, device=dev)
    collective.all_reduce(t, collective.ReduceOp.MAX)
    return bool(t[0].item() > 0), float(t[1].item())


def _vote(err):
    """Raise ``TrialFailed`` on every rank when any rank's `err` is set,
    naming each failing rank's error."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.env import get_world_size

    failed, _ = _agree(err is not None)
    if not failed:
        return
    errs = [err]
    if get_world_size() > 1:
        errs = collective.all_gather_object([], err)
    raise TrialFailed("; ".join(f"rank {r}: {e}" for r, e in enumerate(errs)
                                if e is not None))


def _err(e) -> str:
    return f"{type(e).__name__}: {e}"[:200]


def compiled_trial_fn(model_fn, batch_fn, optimizer_fn, warmup=1, iters=3):
    """A trial runner that times real steps in the live world (see the
    module's docstring). Every rank calls the returned function with the
    same config.

    model_fn() -> (model, loss_fn) for ``TrainStep``, or (embed, blocks,
                  head, loss_fn) for the pipelined path (the whole model;
                  each rank keeps its stage's blocks, the embedding on the
                  first stage and the head on the last), built after the
                  candidate's mesh (and, with pp > 1, its hcg) is in place;
    batch_fn(config) -> the global batch (a tuple, labels last; ids and
                  labels for the pipelined path);
    optimizer_fn(params) -> optimizer.
    """
    meshes: dict = {}

    def _mesh(cfg):
        from paddle_tpu_torch.distributed.mesh import RankMesh, set_mesh

        key = tuple(cfg.as_axes().items())
        if key not in meshes:
            meshes[key] = RankMesh(cfg.as_axes())
        set_mesh(meshes[key])
        return meshes[key]

    def _build(cfg):
        from paddle_tpu_torch.distributed import fleet

        fleet.reset()
        mesh = _mesh(cfg)
        if cfg.pp > 1:
            from paddle_tpu_torch.parallel.pipeline import (
                pipeline_hcg, stage_block_indices)

            pipeline_hcg(mesh)
            embed, blocks, head, loss_fn = model_fn()
            stage = mesh.coord()["pp"]
            blocks = [blocks[i] for i in stage_block_indices(
                len(blocks), cfg.pp, stage, 1)]
            embed = embed if stage == 0 else None
            head = head if stage == cfg.pp - 1 else None
            params = [p for part in [embed, *blocks, head]
                      if part is not None for p in part.parameters()]
            return mesh, (embed, blocks, head, loss_fn), params
        model, loss_fn = model_fn()
        return mesh, (model, loss_fn), list(model.parameters())

    def _step(cfg, mesh, parts, params):
        if cfg.pp > 1:
            from paddle_tpu_torch.parallel.pipeline import PipelinedTrainStep
            from paddle_tpu_torch.parallel.zero_bubble import (
                ZBH1PipelinedStep)

            embed, blocks, head, loss_fn = parts
            if cfg.schedule_mode.upper().replace("-", "") == "ZBH1":
                # time the zero-bubble schedule itself, not its 1F1B twin
                return ZBH1PipelinedStep(
                    embed, blocks, head, loss_fn, mesh=mesh,
                    optimizer=optimizer_fn(params),
                    num_micro=cfg.micro_batches)
            return PipelinedTrainStep(
                embed, blocks, head, loss_fn, optimizer=optimizer_fn(params),
                mesh=mesh, num_micro=cfg.micro_batches, remat=False)
        from paddle_tpu_torch.parallel.train_step import TrainStep

        model, loss_fn = parts
        return TrainStep(model, loss_fn, optimizer_fn(params), mesh=mesh,
                         zero_axis="sharding" if cfg.sharding > 1 else None)

    def _steps(step, batch, n):
        for _ in range(n):
            float(step(*batch))

    def run_trial(cfg: TunerConfig) -> float:
        import torch

        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.distributed.mesh import get_mesh, set_mesh

        prev = get_mesh(), fleet._hcg[0], fleet._strategy[0]
        held = {}
        try:
            err = None
            try:
                mesh, parts, params = _build(cfg)
                held.update(parts=parts, batch=tuple(batch_fn(cfg)))
            except Exception as e:
                err = _err(e)
            _vote(err)
            try:
                held["step"] = _step(cfg, mesh, held["parts"], params)
                _steps(held["step"], held["batch"], warmup)
            except Exception as e:
                err = _err(e)
            _vote(err)
            t0 = time.perf_counter()
            try:
                _steps(held["step"], held["batch"], iters)
            except Exception as e:
                err = _err(e)
            mine = (time.perf_counter() - t0) / max(iters, 1)
            _vote(err)
            return _agree(False, mine)[1]
        finally:
            held.clear()
            set_mesh(prev[0])
            fleet._hcg[0], fleet._strategy[0] = prev[1], prev[2]
            if torch.cuda.is_available():
                torch.cuda.empty_cache()

    return run_trial
