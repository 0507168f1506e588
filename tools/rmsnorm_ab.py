#!/usr/bin/env python3
"""The RMSNorm kernels on one GPU, one source tree against another.

    python3 tools/rmsnorm_ab.py --trees proof_tree/parent . . proof_tree/parent
    python3 tools/rmsnorm_ab.py --trees . --sweep

For each tree, in the order given (parent, change, change, parent puts
drift on both sides), a subprocess imports ``paddle_tpu_torch`` from that
tree, builds its ``rmsnorm.cu`` with nvcc, and runs every case of THIS
tree's ``chip_smoke.rmsnorm_cases()`` through it with
``chip_smoke.run_rmsnorm_case``: y, dx and dw held against the tree's plain
versions by ``chip_smoke.py``'s rules, and timed: the kernels' device ms
(torch.profiler; the backward's sums its dw kernel), the share of the
bound, ``F.rms_norm``'s device ms. With ``--sweep``, the forward's and the
backward's device ms at row blocks 1 to 128 besides, for the cases in
SWEEP. Prints one JSON line a tree run, then device ms by case and tree;
writes everything to ``chiprun_out/rmsnorm_ab.json``. Needs one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = ("r4096_d4096_bf16", "r8_d4096_bf16", "r8192_d1024_bf16",
         "r4097_d1000_bf16", "r4096_d4096_fp32")
SWEEP_BLOCKS = (1, 2, 4, 8, 16, 32, 64, 128)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep(cs, rk, gen, rows, d, dtype):
    """{row block: [forward, backward + dw] device ms} at each block of
    SWEEP_BLOCKS up to the row count."""
    import torch

    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
         ).to(dtype)
    dy = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    out = {}
    for br in SWEEP_BLOCKS:
        if br > rows:
            break
        f = cs._device_ms_sum(
            lambda: rk.rmsnorm_fwd(x, w, cs.RMS_EPS, br), "rmsnorm_fwd")
        b = cs._device_ms_sum(
            lambda: rk.rmsnorm_bwd(x, w, dy, cs.RMS_EPS, br),
            "rmsnorm_bwd", "rmsnorm_dw")
        out[br] = [f, b]
    return out


def worker(tree, seed, sweep):
    """Runs the cases through `tree`'s package; returns {label: result}."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = _chip_smoke()
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import rmsnorm_kernel as rk

    assert _build.__file__.startswith(os.path.abspath(tree)), _build.__file__
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_ab: no CUDA device")
    _build.build_all(["rmsnorm"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for label, rows, d, dt, wdt in cs.rmsnorm_cases():
        r = cs.run_rmsnorm_case(gen, rows, d, dt, wdt)
        out[label] = {"ok": r["ok"], "block_rows": r["block_rows"],
                      "routes": {k: v["took"] for k, v in r["routes"].items()}}
        for k in ("fwd", "bwd", "dw"):
            out[label][k] = {n: r[k][n] for n in (
                "max_abs_err", "ms", "call_ms", "bound_ms", "bound_share",
                "library_ms")}
        if sweep and label in SWEEP:
            out[label]["sweep"] = _sweep(cs, rk, gen, rows, d, dt)
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--tree", help=argparse.SUPPRESS)   # the worker
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.tree:
        res = worker(args.tree, args.seed, args.sweep)
        print("RMSNORM_AB " + json.dumps({"tree": args.tree, "cases": res}),
              flush=True)
        return 0 if all(r["ok"] for r in res.values()) else 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    runs, rc = [], 0
    for tree in args.trees:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree, "--seed", str(args.seed)]
                           + (["--sweep"] if args.sweep else []),
                           capture_output=True, text=True, timeout=1500)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("RMSNORM_AB ")]
        if p.returncode or not line:
            print(f"tree {tree}: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                  f"{p.stderr[-3000:]}", flush=True)
            rc = 1
        if line:
            runs.append(json.loads(line[-1][len("RMSNORM_AB "):]))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "rmsnorm_ab.json"),
              "w") as fh:
        json.dump({"gpu": smi, "runs": runs}, fh, indent=1)
    for label in [lb for lb, *_ in _chip_smoke().rmsnorm_cases()]:
        for k in ("fwd", "bwd"):
            cells = []
            for r in runs:
                c = r["cases"].get(label)
                if c is None:
                    continue
                share = c[k]["bound_share"]
                cells.append(
                    f"{r['tree']} {c[k]['ms']:.4f}"
                    f" ({'-' if share is None else f'{share:.3f}'},"
                    f" {c['routes'][k]})"
                    f"{'' if c['ok'] else ' FAILED'}")
            lib = next((r["cases"][label][k]["library_ms"]
                        for r in runs if label in r["cases"]), None)
            print(f"{label} {k}: device ms (share of bound, route) "
                  + ", ".join(cells)
                  + f"; F.rms_norm {'-' if lib is None else f'{lib:.4f}'}",
                  flush=True)
        for r in runs:
            sw = r["cases"].get(label, {}).get("sweep")
            if sw:
                print(f"{label} {r['tree']} by row block [fwd, bwd]: "
                      + " ".join(f"{b}:[{f:.4f}, {bw:.4f}]"
                                 for b, (f, bw) in sw.items()), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
