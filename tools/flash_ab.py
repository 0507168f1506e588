#!/usr/bin/env python3
"""The flash forward and backward kernels on one GPU, one source tree
against another.

    python3 tools/flash_ab.py --trees proof_tree/parent . . proof_tree/parent

For each tree, in the order given (parent, change, change, parent puts
drift on both sides), a subprocess imports ``paddle_tpu_torch`` from that
tree, builds its ``flash_fwd.cu`` and ``flash_bwd.cu`` with nvcc, and
runs every case of THIS tree's ``chip_smoke.flash_cases()`` and
``chip_smoke.flash_bwd_cases()`` (the shared generator seeded 0, cases
with their own generator seeded from their label) through
``chip_smoke.run_flash_case``/``run_flash_bwd_case``, except the cases a
tree's wrappers cannot take (``kv_segment_ids`` before the sep slice):
each output held to the tree's plain version, a sha256 of the outputs
(forward: out and lse; backward: dq, dk, dv), and the kernels' device ms
(torch.profiler). Equal digests across trees are bit-equal outputs.
Prints the ptxas lines of each tree's flash kernels, one JSON line a tree
run, then device ms and digests by case and tree; writes everything to
``chiprun_out/flash_ab.json``. Needs one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree):
    """Runs the cases through `tree`'s package: (ptxas lines, {label:
    result})."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = _chip_smoke()
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    assert _build.__file__.startswith(os.path.abspath(tree)), _build.__file__
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = ["flash_fwd", "flash_bwd"]
    _build.build_all(sources)
    ptxas = []
    for name in sources:
        lines = _build.build_log(name).splitlines()
        ptxas += [" | ".join(x.strip() for x in lines[i:i + 3])
                  for i, ln in enumerate(lines)
                  if "Compiling entry" in ln and "visit" not in ln]
    takes_kv = "kv_segment_ids" in inspect.signature(
        fa.flash_attention_fwd).parameters
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for kind, cases, run in (("fwd", cs.flash_cases, cs.run_flash_case),
                             ("bwd", cs.flash_bwd_cases,
                              cs.run_flash_bwd_case)):
        for label, kw in cases(gen):
            if "kv_seg" in kw and not takes_kv:
                continue
            g, kw = cs._paged_gen(gen, 0, label, kw)
            r = run(g, **kw)
            if kind == "fwd":
                ms = {"fwd": r["ms"]}
            else:
                ms = {n: k["ms"] for n, k in r["kernels"].items()}
            out[f"{kind} {label}"] = {"ok": r["ok"], "digest": r["digest"],
                                      "ms": ms}
            torch.cuda.empty_cache()
    return ptxas, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--tree", help=argparse.SUPPRESS)   # the worker
    args = ap.parse_args(argv)
    if args.tree:
        ptxas, res = worker(args.tree)
        print("FLASH_AB " + json.dumps({"tree": args.tree, "ptxas": ptxas,
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
                if ln.startswith("FLASH_AB ")]
        if p.returncode or not line:
            print(f"tree {tree}: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                  f"{p.stderr[-3000:]}", flush=True)
            rc = 1
        if line:
            runs.append(json.loads(line[-1][len("FLASH_AB "):]))
            for ln in runs[-1]["ptxas"]:
                print(f"{tree} ptxas {ln}", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "flash_ab.json"),
              "w") as fh:
        json.dump({"gpu": smi, "runs": runs}, fh, indent=1)
    labels = [label for r in runs for label in r["cases"]]
    for label in dict.fromkeys(labels):
        cells = [f"{r['tree']} {json.dumps(c['ms'])} {c['digest'][:12]}"
                 f"{'' if c['ok'] else ' WRONG'}"
                 for r in runs for c in [r["cases"].get(label)] if c]
        same = len({c["digest"] for r in runs
                    for c in [r["cases"].get(label)] if c}) == 1
        print(f"{label}: {'bit-equal' if same else 'DIFFER'}; "
              + ", ".join(cells), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
