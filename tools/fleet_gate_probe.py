#!/usr/bin/env python3
"""What ``chip_smoke.py``'s ``fleet_full_width`` gates read on a sound run
and on runs with a fault planted, so that each limit sits between them.

    python3 tools/fleet_gate_probe.py [--cases clean,mp_o_proj,...] [--seed 0]

Each case runs the phase as ``chip_smoke.py`` runs it (the 7B width, 3
layers, mp 2 x sharding 2 with ZeRO-1, 4 gloo ranks on one card, the
single-rank model beside). A fault is put in at run time in the ranks'
processes; no file changes. Cases:

* ``clean``: the phase as it is;
* ``mp_o_proj``: mp rank 1 drops the forward all-reduce's sum in layer
  0's ``o_proj`` (the first ``RowParallelLinear`` built) for its local
  partial product, so its hidden states lack the other rank's half of
  that attention output;
* ``zero_update``: sharding rank 1 drops its AdamW update every step, so
  its slice of every parameter keeps its old values on every rank;
* ``memorised``: every step trains on step 0's batch, where the loss
  falls toward 0 and the CE backward's d-logits become rounding; the CE
  calls' fp64 witness readings (``chip_smoke._CeCalls``).

Prints one JSON line a case: the gates' readings (first and second loss,
the gradient norms of steps 0 and 1, each rank's losses, every CE call's
error against its plain version and both distances from the fp64
result) and the gates that failed. Writes them to
``chiprun_out/fleet_gate_probe.json``. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CASES = ("clean", "mp_o_proj", "zero_update", "memorised")


def _rank_mp_o_proj(out_dir, seed):
    from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_layers as L
    from paddle_tpu_torch.nn import functional as F

    built = []
    init, forward = L.RowParallelLinear.__init__, L.RowParallelLinear.forward

    def counted_init(self, *a, **k):
        init(self, *a, **k)
        built.append(self)

    def faulty_forward(self, x):
        if self is built[0] and self.group.rank == 1:
            # the all-reduce still runs, so the ranks' collectives stay
            # paired; its sum is dropped for the local partial product
            forward(self, x)
            return F.linear(x, self.weight, self.bias)
        return forward(self, x)

    L.RowParallelLinear.__init__ = counted_init
    L.RowParallelLinear.forward = faulty_forward
    cs._fleet_full_rank(out_dir, seed)


def _rank_zero_update(out_dir, seed):
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        dygraph_sharding_optimizer as D

    step = D.DygraphShardingOptimizer.step

    def faulty_step(self):
        if self._group.rank != 1:
            return step(self)
        inner, update = self._inner_opt, self._inner_opt.step

        def dropped_update():
            # the update runs (with whatever collectives it holds), and
            # this rank's slices are put back to their old values
            old = [s.detach().clone() for s in self._slices]
            update()
            with torch.no_grad():
                for s, o in zip(self._slices, old):
                    s.copy_(o)

        inner.step = dropped_update
        try:
            return step(self)
        finally:
            del inner.step

    D.DygraphShardingOptimizer.step = faulty_step
    cs._fleet_full_rank(out_dir, seed)


def _run_case(case, seed, report):
    rank_fn, batches_fn = cs._fleet_full_rank, cs._fleet_full_batches
    if case == "mp_o_proj":
        cs._fleet_full_rank = _rank_mp_o_proj
    elif case == "zero_update":
        cs._fleet_full_rank = _rank_zero_update
    elif case == "memorised":
        cs._fleet_full_batches = lambda cfg, s: (
            [batches_fn(cfg, s)[0]] * (cs.FLEET_WARMUP + cs.FLEET_STEPS))
    failed = []
    try:
        cs.phase_fleet_full_width(argparse.Namespace(seed=seed), report)
    except AssertionError as e:
        failed = [str(e)]
    finally:
        cs._fleet_full_rank, cs._fleet_full_batches = rank_fn, batches_fn
    out = report.pop("fleet_full_width")
    ranks = out["ranks"]
    return {
        "case": case, "gpu": report["gpu"], "gates_failed": failed,
        "first_loss_rel_err": out["first_loss_rel_err"],
        "second_loss_rel_err": out["second_loss_rel_err"],
        "grad_norm_rel_errs": out["grad_norm_rel_errs"],
        "ref_losses": out["ref_losses"],
        "ref_grad_norms": out["ref_grad_norms"],
        "losses": [r["losses"] for r in ranks],
        "warm_grad_norms": [r["warm_grad_norms"] for r in ranks],
        "ce_calls": [r["ce_calls"] for r in ranks],
        "median_step_ms": [r["median_step_ms"] for r in ranks],
        "limits": {"loss": cs.FLEET_LOSS_RTOL,
                   "grad_norm": cs.FLEET_GNORM_RTOL,
                   "ce_bwd_rtol": cs.CE_BWD_RTOL,
                   "ce_bwd_fp64_floor": cs.CE_BWD_FP64_FLOOR}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cases = [c for c in args.cases.split(",") if c]
    unknown = sorted(set(cases) - set(CASES))
    if unknown:
        ap.error(f"unknown cases {unknown}; known: {CASES}")

    import torch

    if not torch.cuda.is_available():
        print("fleet_gate_probe: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    report = {"gpu": smi[0] if smi else "nvidia-smi: no output"}
    print(report["gpu"], flush=True)
    _build.build_all()
    results = []
    for case in cases:
        res = _run_case(case, args.seed, report)
        print(f"fleet_gate_probe: {json.dumps(res)}", flush=True)
        results.append(res)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fleet_gate_probe.json"),
              "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
