#!/usr/bin/env python3
"""The fused-CE backward's kernels on one GPU, as built and as variants.

    python3 tools/ce_bwd_ab.py [--chunks 131 1024 4096] [--rounds 2]

Builds ``csrc/ce_bwd.cu`` as it is and as text variants of it, each with
nvcc into a temporary directory (one process each, all at once),
binds each library's ``ptt_ce_bwd`` in turn under ``fused_ce.ce_bwd``
and runs the LLaMA step's shape (N 4096, H 4096, V 32000, bf16, random
inputs as ``chip_smoke.py``'s ``ce_bwd`` cases) at each token chunk:
device ms of every kernel (torch.profiler), their sum, and the row error
of dx and dW against ``ce_bwd_reference`` in fp64. Variants, rounds in
turn so drift falls on all:

* ``as_built``: the source as it is;
* ``promote_every_stage``: the tensor cores' runs promoted every 64 deep
  instead of every 256;
* ``no_l2_prefetch``: dW's tile rows not prefetched into L2;
* ``unbatched_epilogue``: dW's old values loaded pair by pair between
  the stores;
* ``neither``: no prefetch and unbatched loads.

Prints one line a (round, variant, chunk); writes them to
``chiprun_out/ce_bwd_ab.json``. Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PREFETCH = 'asm volatile("prefetch.global.L2 [%0];\\n" ::"l"('
BATCHED = """    float2 old[kBN / 8];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j;
      old[j] = ADD && col < cols ? *reinterpret_cast<const float2*>(yr + col)
                                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= cols) continue;
      *reinterpret_cast<float2*>(yr + col) =
          make_float2(old[j].x + acc[4 * j + 2 * h],
                      old[j].y + acc[4 * j + 2 * h + 1]);
    }"""
UNBATCHED = """#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= cols) continue;
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      float2* p = reinterpret_cast<float2*>(yr + col);
      if (ADD) {
        const float2 o = *p;
        v.x = o.x + v.x;
        v.y = o.y + v.y;
      }
      *p = v;
    }"""
PROMOTE = "constexpr int kPromote = 4;"


def _variants(src):
    for text in (PREFETCH, BATCHED, PROMOTE):
        if src.count(text) != 1:
            raise SystemExit(f"ce_bwd.cu no longer holds {text[:40]!r}")
    no_pf = src.replace(PREFETCH, "if (0) " + PREFETCH)
    return {"as_built": src,
            "promote_every_stage": src.replace(
                PROMOTE, "constexpr int kPromote = 1;"),
            "no_l2_prefetch": no_pf,
            "unbatched_epilogue": src.replace(BATCHED, UNBATCHED),
            "neither": no_pf.replace(BATCHED, UNBATCHED)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[131, 1024,
                                                               4096])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ce_bwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import fused_ce as fc

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = tempfile.mkdtemp(prefix="ce_bwd_ab_")
    with open(os.path.join(_build.CSRC_DIR, "ce_bwd.cu")) as fh:
        variants = _variants(fh.read())
    jobs = {}
    for name, src in variants.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    _build.build_all(["fused_ce"])
    libs = {}
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"{name}.so")).ptt_ce_bwd
        fn.argtypes = [vp] * 9 + [ci] * 8 + [cf, cf, ci, vp]
        fn.restype = ci
        libs[name] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n, h, v = 4096, 4096, 32000
    x = torch.randn((n, h), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((v, h), generator=gen, device="cuda") * 0.02).bfloat16()
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
    ct = (torch.rand((n,), generator=gen, device="cuda") + 0.5) / n
    m, s, _, _ = fc.ce_stats(x, w, labels)
    lse = m + torch.log(s)
    ref = fc.ce_bwd_reference(x.double(), w.double(), labels, lse.double(),
                              ct.double(), -100, 0.0, 0.0, 0)
    rows = []
    built = fc._lib_bwd
    try:
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                fc._lib_bwd = lambda lib=lib: lib
                for chunk in args.chunks:
                    call = lambda: fc.ce_bwd(  # noqa: E731
                        x, w, labels, lse, ct, -100, 0.0, 0.0, chunk)
                    dx, dw = call()
                    torch.cuda.synchronize()
                    errs = {"dx": cs._row_rule(dx, ref[0], 1e-5)[0],
                            "dw": cs._row_rule(dw, ref[1], 1e-5)[0]}
                    del dx, dw
                    by = cs._device_ms_by_kernel(call, reps=3)
                    ks = {re.search(r"ce_bwd_(\w+)_kernel", k).group(1): ms
                          for k, ms in by.items() if "ce_bwd" in k}
                    row = dict(round=rnd, variant=name, chunk=chunk,
                               ms=sum(ks.values()), kernel_ms=ks,
                               err_vs_fp64=errs, gpu=smi)
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    finally:
        fc._lib_bwd = built
        shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "ce_bwd_ab.json"),
              "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
