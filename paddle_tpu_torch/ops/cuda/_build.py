"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

and is loaded with ``ctypes``. The file name carries a hash of the sources
and flags, so an edited kernel rebuilds and a stale library is never loaded.
``build_all`` starts one ``nvcc`` per source, all at once. Nothing here runs
at import: the CPU tests import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["build_all", "load", "kernel_names", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on a machine with the CUDA toolkit")


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC_DIR)):
        if f == f"{name}.cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Spawn nvcc for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    with open(target[:-3] + ".log", "w") as fh:
        fh.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all(names=None) -> dict[str, float]:
    """Compile every kernel source not yet built, one nvcc each, all in
    parallel. Returns {name: seconds} for the builds that ran."""
    names = list(names or kernel_names())
    with _lock:
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in names}
        times = {}
        try:
            for n, job in jobs.items():
                if job is not None:
                    _finish(n, job)
                    times[n] = time.perf_counter() - t0
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        return times


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    current build of `name`."""
    path = _target(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(_target(name))
                _libs[name] = lib
    return lib
