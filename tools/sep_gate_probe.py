#!/usr/bin/env python3
"""What ``chip_smoke.py``'s ``sep_full_width`` gates read on a sound run
and on runs with a fault planted, so that each limit sits between them.

    python3 tools/sep_gate_probe.py [--cases clean,rope_offset,...]
                                    [--seed 0]

Each case runs the phase as ``chip_smoke.py`` runs it (phase 7's model at
the 7B width, bf16, sep 4, one 16,384-token row a step, 4 gloo ranks on
one card, the single-rank model on the same tokens before them). A fault
is put in at run time in the ranks' processes; no file changes. Cases:

* ``clean``: the phase as it is;
* ``rope_offset``: sep rank 1 rotates its queries and keys at positions
  0..4095 instead of its segment's 4096..8191 (the global RoPE offset
  forgotten on one rank);
* ``skip_block``: sep rank 2 leaves out the block of sep rank 0 in every
  layer's ring, forward and backward alike (a hop's block dropped);
* ``sep_grad_avg``: the gradients are averaged over the sep group where
  they must be summed (each rank's loss is already its share of the
  mean), so they are 4 times too small.

Prints one JSON line a case: the gates' readings (the first two losses'
and the step-0 and step-1 gradient norms' relative errors against the
single rank's, each rank's losses and norms) and the gates that failed.
Writes them to ``chiprun_out/sep_gate_probe.json``. Needs one card.
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

CASES = ("clean", "rope_offset", "skip_block", "sep_grad_avg")


def _rank_rope_offset(out_dir, seed):
    from paddle_tpu_torch.distributed.env import get_rank
    from paddle_tpu_torch.models import llama

    real = llama.apply_rotary
    cfg = cs._sep_full_config()

    def faulty(q, k, cos, sin):
        if get_rank() == 1 and cos.dim() == 2:
            c0, s0 = llama._shared_rope_tables(q.shape[-1], cs.SEP_SEQ,
                                               cfg.rope_theta, q.device)
            n = q.shape[1]
            cos, sin = c0[:n].to(q.dtype), s0[:n].to(q.dtype)
        return real(q, k, cos, sin)

    llama.apply_rotary = faulty
    cs._sep_full_rank(out_dir, seed)


def _rank_skip_block(out_dir, seed):
    from paddle_tpu_torch.distributed.env import get_rank
    from paddle_tpu_torch.parallel import ring_attention as ra

    real = ra._skipped

    def faulty(causal, src, r):
        return real(causal, src, r) or (get_rank() == 2 and src == 0)

    ra._skipped = faulty
    cs._sep_full_rank(out_dir, seed)


def _rank_sep_grad_avg(out_dir, seed):
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        hybrid_parallel_optimizer as H

    real = H.fused_allreduce_gradients

    def faulty(params, hcg):
        real(params, hcg)
        n = hcg.get_sep_parallel_world_size()
        for p in params:
            if p.grad is not None:
                p.grad.div_(n)

    H.fused_allreduce_gradients = faulty
    cs._sep_full_rank(out_dir, seed)


_RANKS = {"rope_offset": _rank_rope_offset, "skip_block": _rank_skip_block,
          "sep_grad_avg": _rank_sep_grad_avg}


def _run_case(case, seed, report):
    rank_fn = cs._sep_full_rank
    if case in _RANKS:
        cs._sep_full_rank = _RANKS[case]
    failed = []
    try:
        cs.phase_sep_full_width(argparse.Namespace(seed=seed), report)
    except AssertionError as e:
        failed = [str(e)]
    finally:
        cs._sep_full_rank = rank_fn
    if "sep_full_width" not in report:     # the phase stopped early
        return {"case": case, "gpu": report["gpu"], "gates_failed": failed,
                "no_readings": True}
    out = report.pop("sep_full_width")
    ranks = out["ranks"]
    return {
        "case": case, "gpu": report["gpu"], "gates_failed": failed,
        "loss_rel_errs": out["loss_rel_errs"],
        "grad_norm_rel_errs": out["grad_norm_rel_errs"],
        "ref_losses": out["ref_losses"],
        "ref_grad_norms": out["ref_grad_norms"],
        "warm_losses": [r["warm_losses"] for r in ranks],
        "warm_grad_norms": [r["warm_grad_norms"] for r in ranks],
        "median_step_ms": [r["timed"]["median_step_ms"] for r in ranks],
        "limits": out["limits"]}


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
        print("sep_gate_probe: CUDA is not available", file=sys.stderr)
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
        print(f"sep_gate_probe: {json.dumps(res)}", flush=True)
        results.append(res)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sep_gate_probe.json"),
              "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
