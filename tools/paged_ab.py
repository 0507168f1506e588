#!/usr/bin/env python3
"""Paged decode on one GPU, one source tree against another.

    python3 tools/paged_ab.py --trees proof_tree/parent . . proof_tree/parent
    python3 tools/paged_ab.py --trees . --cases all

For each tree, in the order given (parent, change, change, parent puts
drift on both sides), a subprocess imports ``paddle_tpu_torch`` from that
tree, builds its paged kernel with nvcc, and runs ``chip_smoke.py``'s paged
cases of THIS tree through it: bf16, int8 and fp8 ``decode_b8_h32`` (B 8,
32/32 heads, D 128, page 16, the eight mixed lengths 0-4095) and one
layer's call of the 7B engine's profiled decode step (8 rows of 1000 keys,
bf16; 32 such calls make the step), or with ``--cases all`` every paged
case ``chip_smoke.py`` has besides. Each case is held
against the tree's plain version by ``chip_smoke.py``'s rules and timed:
device ms of the decode kernel and the split-K merge (torch.profiler), the
event-timed call, the bound. Prints one JSON line a tree run, then a
summary of device ms by case and tree; writes everything to
``chiprun_out/paged_ab.json``. Needs one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = ("decode_b8_h32", "int8_decode_b8_h32", "fp8_decode_b8_h32",
        "decode_8x1000")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree, cases, seed):
    """Runs the cases through `tree`'s package; returns {label: result}."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = _chip_smoke()
    from paddle_tpu_torch.ops.cuda import _build

    assert _build.__file__.startswith(os.path.abspath(tree)), _build.__file__
    if not torch.cuda.is_available():
        raise SystemExit("paged_ab: no CUDA device")
    _build.build_all(["paged_attention"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    # the 7B engine's decode_8x1000 profile step, one layer's call: 8 rows
    # of 1000 keys in a 4096-token page table
    todo = [("decode_8x1000", dict(t=1, hq=32, hkv=32, lens=[1000] * 8,
                                   dtype=torch.bfloat16), cs.run_paged_case)]
    todo += [(lb, kw, cs.run_paged_case) for lb, kw in cs.paged_cases()]
    todo += [(lb, kw, cs.run_paged_quant_case)
             for lb, kw in cs.paged_quant_cases()]
    out = {}
    for label, kw, run in todo:
        if cases != "all" and label not in MAIN:
            continue
        g, kw = cs._paged_gen(gen, seed, label, kw)
        r = run(g, **kw)
        keep = ("ok", "max_abs_err", "max_rel_err", "excess_err",
                "ms", "decode_ms", "combine_ms", "call_ms", "host_ms",
                "kernels",
                "bound_ms", "bound_share", "gbps", "plain_ms")
        out[label] = {k: r[k] for k in keep if k in r}
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--tree", help=argparse.SUPPRESS)   # the worker
    ap.add_argument("--cases", choices=("main", "all"), default="main")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.tree:
        res = worker(args.tree, args.cases, args.seed)
        print("PAGED_AB " + json.dumps({"tree": args.tree, "cases": res}),
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
                            "--tree", tree, "--cases", args.cases,
                            "--seed", str(args.seed)],
                           capture_output=True, text=True, timeout=1500)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("PAGED_AB ")]
        if p.returncode or not line:
            print(f"tree {tree}: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                  f"{p.stderr[-3000:]}", flush=True)
            rc = 1
        if line:
            runs.append(json.loads(line[-1][len("PAGED_AB "):]))
            print(line[-1], flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "paged_ab.json"), "w") as fh:
        json.dump({"gpu": smi, "runs": runs}, fh, indent=1)
    for label in sorted({lb for r in runs for lb in r["cases"]}):
        cells = [f"{r['tree']} {r['cases'][label]['ms']:.4f}"
                 f"{'' if r['cases'][label]['ok'] else ' (FAILED)'}"
                 for r in runs if label in r["cases"]]
        print(f"{label}: device ms " + ", ".join(cells), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
