#!/usr/bin/env python3
"""What ``chip_smoke.py``'s ``moe_ep_full_width`` gates read on a sound run
and on runs with a fault planted, so that each limit sits between them.

    python3 tools/moe_ep_gate_probe.py [--cases clean,expert_scale,...]
                                       [--seed 0]

Each case runs the phase as ``chip_smoke.py`` runs it (GPT-MoE at its full
width and depth, bf16, ep 4, 4 gloo ranks on one card, the single-rank
model beside). A fault is put in at run time in the ranks' processes; no
file changes. Cases:

* ``clean``: the phase as it is;
* ``expert_scale``: the experts' gradients are averaged over dp only, not
  divided by ep as well (the owner's gradient counts every ep rank's rows
  already), so they are 4 times too large;
* ``combine_owner``: rank 1 zeroes, in layer 0's forward, the outputs its
  tokens got back from the experts of ep rank 2 (the combine all-to-all
  still runs, so the ranks' exchanges stay paired);
* ``aux_grad``: the load-balance loss's gradient is taken 4 times (as an
  all-reduce whose backward sums over the ep group would), so the gates'
  gradients from it are 4 times too large.

Prints one JSON line a case: the gates' readings (first and second loss,
the gradient norms of steps 0 and 1, each rank's losses and norms, the
grouped-matmul calls' worst errors) and the gates that failed. Writes them
to ``chiprun_out/moe_ep_gate_probe.json``. Needs one card.
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

CASES = ("clean", "expert_scale", "combine_owner", "aux_grad")


def _rank_expert_scale(out_dir, seed):
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        hybrid_parallel_optimizer as H
    from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util \
        import is_ep_sharded

    real = H.fused_allreduce_gradients

    def faulty(params, hcg):
        real(params, hcg)
        ep = hcg.get_expert_parallel_world_size()
        for p in params:
            if p.grad is not None and is_ep_sharded(p):
                p.grad.mul_(ep)

    H.fused_allreduce_gradients = faulty
    cs._moe_ep_full_rank(out_dir, seed)


def _rank_combine_owner(out_dir, seed):
    import torch

    from paddle_tpu_torch.distributed.env import get_rank
    from paddle_tpu_torch.incubate.distributed.models.moe import dropless

    real = dropless.global_gather
    calls = [0]

    def faulty(x, local_count, global_count, group=None):
        y = real(x, local_count, global_count, group=group)
        layer = calls[0] % 12        # one combine a layer a forward
        calls[0] += 1
        if layer == 0 and get_rank() == 1:
            cap = y.shape[0] // group.nranks
            keep = torch.ones((y.shape[0], 1), dtype=y.dtype,
                              device=y.device)
            keep[2 * cap:3 * cap] = 0
            y = y * keep
        return y

    dropless.global_gather = faulty
    cs._moe_ep_full_rank(out_dir, seed)


def _rank_aux_grad(out_dir, seed):
    from paddle_tpu_torch.incubate.distributed.models.moe import dropless

    def backward(ctx, dy):
        return dy * 4, None

    dropless._ValueOf.backward = staticmethod(backward)
    cs._moe_ep_full_rank(out_dir, seed)


_RANKS = {"expert_scale": _rank_expert_scale,
          "combine_owner": _rank_combine_owner, "aux_grad": _rank_aux_grad}


def _run_case(case, seed, report):
    rank_fn = cs._moe_ep_full_rank
    if case in _RANKS:
        cs._moe_ep_full_rank = _RANKS[case]
    failed = []
    try:
        cs.phase_moe_ep_full_width(argparse.Namespace(seed=seed), report)
    except AssertionError as e:
        failed = [str(e)]
    finally:
        cs._moe_ep_full_rank = rank_fn
    if "moe_ep_full_width" not in report:     # the phase stopped early
        return {"case": case, "gpu": report["gpu"], "gates_failed": failed,
                "no_readings": True}
    out = report.pop("moe_ep_full_width")
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
        "gmm_calls": [r["gmm_calls"] for r in ranks],
        "median_step_ms": [r["median_step_ms"] for r in ranks],
        "limits": {"loss": cs.MOE_EP_LOSS_RTOL,
                   "grad_norm": cs.MOE_EP_GNORM_RTOL}}


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
        print("moe_ep_gate_probe: CUDA is not available", file=sys.stderr)
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
        print(f"moe_ep_gate_probe: {json.dumps(res)}", flush=True)
        results.append(res)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "moe_ep_gate_probe.json"),
              "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
