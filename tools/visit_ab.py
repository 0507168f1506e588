#!/usr/bin/env python3
"""The flash block-visit, page-visit and grouped visit counters on one
GPU, one source tree against another.

    python3 tools/visit_ab.py --trees proof_tree/parent . . proof_tree/parent

For each tree, in the order given (parent, change, change, parent puts
drift on both sides), a subprocess imports ``paddle_tpu_torch`` from that
tree, builds its ``flash_fwd.cu``, ``paged_attention.cu`` and
``grouped_matmul.cu`` with nvcc, and runs every case of THIS tree's
``chip_smoke.visit_cases()`` through ``chip_smoke.run_visit_cases`` and
every layout of its ``chip_smoke.gmm_layouts()`` (seed 0) through
``chip_smoke.run_gmm_visit_cases``: each count held exactly against the
tree's plain versions (pages against ceil(len / page_size), groups
against ``expected_visit_counts`` too) and timed: the kernel's device ms
(torch.profiler) beside the launch floor, one 1-element fill's device ms
in the same process. Prints one JSON line a tree run, then device ms by
case and tree; writes everything to ``chiprun_out/visit_ab.json``. Needs
one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("ok", "ms", "call_ms", "plain_ms", "bound_ms", "launch_floor_ms",
        "visited", "visited_tiles")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree):
    """Runs the cases through `tree`'s package; returns {label: result}."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = _chip_smoke()
    from paddle_tpu_torch.ops.cuda import _build

    assert _build.__file__.startswith(os.path.abspath(tree)), _build.__file__
    if not torch.cuda.is_available():
        raise SystemExit("visit_ab: no CUDA device")
    sources = ["flash_fwd", "paged_attention", "grouped_matmul"]
    _build.build_all(sources)
    ptxas = []
    for name in sources:
        lines = _build.build_log(name).splitlines()
        ptxas += [" | ".join(x.strip() for x in lines[i:i + 3])
                  for i, ln in enumerate(lines)
                  if "Compiling entry" in ln and "visit_kernel" in ln]
    cases = cs.run_visit_cases()
    cases.update(("gmm_" + label, r) for label, r in cs.run_gmm_visit_cases(
        cs.gmm_layouts(torch.Generator(device="cuda").manual_seed(0))
    ).items())
    return ptxas, {label: {k: r.get(k) for k in KEYS}
                   for label, r in cases.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--tree", help=argparse.SUPPRESS)   # the worker
    args = ap.parse_args(argv)
    if args.tree:
        ptxas, res = worker(args.tree)
        print("VISIT_AB " + json.dumps({"tree": args.tree, "ptxas": ptxas,
                                        "cases": res}), flush=True)
        return 0 if all(r["ok"] for r in res.values()) else 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    runs, rc = [], 0
    for tree in args.trees:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree], capture_output=True, text=True,
                           timeout=900)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("VISIT_AB ")]
        if p.returncode or not line:
            print(f"tree {tree}: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                  f"{p.stderr[-3000:]}", flush=True)
            rc = 1
        if line:
            runs.append(json.loads(line[-1][len("VISIT_AB "):]))
            for ln in runs[-1]["ptxas"]:
                print(f"{tree} ptxas {ln}", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "visit_ab.json"),
              "w") as fh:
        json.dump({"gpu": smi, "runs": runs}, fh, indent=1)
    labels = [label for label, *_ in _chip_smoke().visit_cases()]
    labels += [label for r in runs[:1] for label in r["cases"]
               if label.startswith("gmm_")]
    for label in labels:
        cells = [f"{r['tree']} {c['ms']:.4f} (floor "
                 f"{c['launch_floor_ms']:.4f}){'' if c['ok'] else ' WRONG'}"
                 for r in runs for c in [r["cases"].get(label)] if c]
        print(f"{label}: device ms " + ", ".join(cells), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
