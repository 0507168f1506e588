"""ctypes bindings of the port's native TCPStore (``csrc/store.cc``;
``paddle_tpu.core.native`` counterpart, the store's half of it).

The library is built on first use with

    g++ -O2 -std=c++17 -shared -fPIC -fvisibility=hidden -o
        csrc/build/libpaddle_tpu_torch_store-<hash>.so csrc/store.cc -lpthread

into the git-ignored ``csrc/build/``. The file name carries a hash of the
source and flags, so an edited source rebuilds and a stale library is never
loaded; the build is serialized across processes with a lock file, so
workers started together never load a half-written library. Without a
toolchain ``lib()`` returns None and ``distributed.store`` runs its
pure-Python twin.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["lib", "available", "library_path", "SOURCE", "BUILD_DIR"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCE = os.path.join(_CSRC, "store.cc")
BUILD_DIR = os.path.join(_CSRC, "build")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden",
             "-Wall"]

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"libpaddle_tpu_torch_store-{h.hexdigest()[:16]}.so")


def _build(target: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    import fcntl

    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(target):     # another process built it
                return True
            tmp = f"{target}.{os.getpid()}.tmp"
            res = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp,
                                  "-lpthread"], capture_output=True,
                                 timeout=120)
            if res.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                return False
            os.replace(tmp, target)
            return True
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def lib():
    """Load (building if needed) the native store; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        target = library_path()
        try:
            if not os.path.exists(target) and not _build(target):
                return None
            L = ctypes.CDLL(target)
        except (OSError, subprocess.SubprocessError):
            return None
        P = ctypes.POINTER(ctypes.c_uint8)
        L.pt_store_server_start.restype = ctypes.c_void_p
        L.pt_store_server_start.argtypes = [ctypes.c_int]
        L.pt_store_server_port.restype = ctypes.c_int
        L.pt_store_server_port.argtypes = [ctypes.c_void_p]
        L.pt_store_server_stop.argtypes = [ctypes.c_void_p]
        L.pt_store_client_connect.restype = ctypes.c_void_p
        L.pt_store_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                              ctypes.c_int]
        L.pt_store_client_close.argtypes = [ctypes.c_void_p]
        L.pt_store_set.restype = ctypes.c_int
        L.pt_store_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, P,
                                   ctypes.c_int]
        L.pt_store_get.restype = ctypes.c_int
        L.pt_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, P,
                                   ctypes.c_int]
        L.pt_store_add.restype = ctypes.c_int64
        L.pt_store_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int64]
        L.pt_store_delete.restype = ctypes.c_int
        L.pt_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        L.pt_store_wait.restype = ctypes.c_int
        L.pt_store_wait.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int64, P, ctypes.c_int]
        _lib = L
        return _lib


def available() -> bool:
    return lib() is not None
