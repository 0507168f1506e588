"""Filesystem abstraction (``paddle_tpu.distributed.fleet.utils.fs``
counterpart; reference: fleet/utils/fs.py — the ``FS`` base, ``LocalFS``,
``HDFSClient`` over the hadoop CLI).

Host-only code: tooling that writes reports or checkpoints programs
against ``FS`` so another store can slot in. ``LocalFS`` is the default
(network mounts look like local paths); ``HDFSClient`` stays gated on a
``hadoop`` binary.
"""
from __future__ import annotations

import os
import shutil

__all__ = ["FS", "LocalFS", "HDFSClient"]


class FS:
    def ls_dir(self, path):
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def mv(self, src, dst, overwrite=False):
        raise NotImplementedError

    def touch(self, path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """reference fs.py ``LocalFS``."""

    def ls_dir(self, path):
        """(directories, files) directly under `path`, each sorted by
        name; two empty lists for a missing path."""
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name))
             else files).append(name)
        return dirs, files

    def is_file(self, path):
        return os.path.isfile(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def mv(self, src, dst, overwrite=False):
        if not overwrite and os.path.exists(dst):
            raise FileExistsError(dst)
        if overwrite and os.path.exists(dst):
            self.delete(dst)
        shutil.move(src, dst)

    def touch(self, path, exist_ok=True):
        if os.path.exists(path):
            if not exist_ok:
                raise FileExistsError(path)
            return
        open(path, "a").close()

    # local copies stand in for upload and download
    def upload(self, local_path, fs_path, overwrite=False):
        self.mkdirs(os.path.dirname(fs_path) or ".")
        if overwrite and os.path.exists(fs_path):
            self.delete(fs_path)
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path)
        else:
            shutil.copy2(local_path, fs_path)

    download = upload


class HDFSClient(FS):
    """Gated: needs the hadoop CLI (on the PATH or under
    ``hadoop_home/bin``) and raises without it."""

    def __init__(self, hadoop_home=None, configs=None, *a, **kw):
        hadoop = shutil.which("hadoop") or (
            os.path.join(hadoop_home, "bin", "hadoop") if hadoop_home
            else None)
        if not hadoop or not os.path.exists(hadoop):
            raise RuntimeError(
                "HDFSClient needs the hadoop CLI, which is not available; "
                "use LocalFS (network mounts look like local paths)")
