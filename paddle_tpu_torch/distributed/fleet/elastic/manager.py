"""The elastic training manager (``paddle_tpu.distributed.fleet.elastic``
counterpart; reference: ``ElasticManager``, fleet/elastic/manager.py:124,
and ``ELASTIC_EXIT_CODE``, :32).

Ranks hold TTL leases in the job's TCPStore
(``/elastic/<job>/lease/<rank>``, the wall clock packed as a double,
renewed every third of the TTL by a heartbeat thread), and a JSON
rendezvous record (``/elastic/<job>/record``: the expected world, the
surviving members, every rank ever expected) persists the membership.
``watch()`` compares the live leases with the members: a lost member
gives ``RESTART`` (the launcher's relaunch at the new width, exit code
``ELASTIC_EXIT_CODE``), or under ``policy="rebuild"`` shrinks the world
in place and rebuilds the mesh over the survivors; a lost rank whose
lease is fresh again is re-admitted (``readmit``), and the caller reloads
its state from the distributed checkpoint at the new width.

The port runs a process per rank, so with more than one process a
rebuild falls back to ``RESTART`` with a warning, as the JAX package does
for more than one process: the mesh over the survivors needs new process
groups. In one process ``_rebuild_mesh`` rebuilds the ``RankMesh`` by the
JAX package's rule over the world's ranks: the non-dp axes are kept where
their product divides the world, and dp takes the rest. The default store
is the job's (``create_or_get_global_tcp_store``), where the launcher's
ranks meet.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import warnings

__all__ = ["ElasticManager", "ElasticStatus", "ELASTIC_EXIT_CODE"]

ELASTIC_EXIT_CODE = 101


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    def __init__(self, args=None, store=None, rank: int | None = None,
                 world_size: int | None = None, lease_ttl: float = 10.0,
                 job_id: str | None = None, policy: str = "relaunch",
                 on_scale=None):
        from paddle_tpu_torch.distributed.store import \
            create_or_get_global_tcp_store

        self.rank = rank if rank is not None else int(
            os.getenv("PADDLE_TRAINER_ID", "0"))
        self.world = world_size if world_size is not None else int(
            os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self.job_id = job_id or os.getenv("PADDLE_JOB_ID", "default")
        self.lease_ttl = lease_ttl
        self.store = store if store is not None else \
            create_or_get_global_tcp_store()
        self.enable = True
        # 'relaunch': a membership change gives RESTART (the reference's
        # default); 'rebuild': shrink the expected world in place and
        # rebuild the mesh over the survivors
        self.policy = policy
        self.on_scale = on_scale          # callback(old_world, new_world)
        self.members = list(range(self.world))     # surviving rank ids
        self.all_ranks = list(range(self.world))   # every rank expected
        self._stop = threading.Event()
        self._heartbeat_thread = None
        self._status = ElasticStatus.HOLD
        # seed the record only when there is none: a recovering rank must
        # not overwrite the shrunk membership before it is re-admitted
        if self.read_record() is None:
            self._write_record()

    def _key(self, r):
        return f"/elastic/{self.job_id}/lease/{r}"

    # -- the rendezvous record ------------------------------------------------
    def _write_record(self):
        try:
            self.store.set(f"/elastic/{self.job_id}/record", json.dumps(
                {"world": self.world, "members": self.members,
                 "all_ranks": self.all_ranks}).encode())
        except (ConnectionError, OSError):
            pass  # the record is advisory; the leases decide

    def read_record(self):
        v = self.store.get(f"/elastic/{self.job_id}/record")
        return json.loads(v.decode()) if v else None

    # -- registration (reference manager.py register/exit) --------------------
    def register(self):
        self._renew()
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat, daemon=True,
            name=f"paddle_tpu_torch.elastic.{self.job_id}.{self.rank}")
        self._heartbeat_thread.start()

    def _renew(self):
        self.store.set(self._key(self.rank), struct.pack("<d", time.time()))

    def _heartbeat(self):
        while not self._stop.is_set():
            self._renew()
            self._stop.wait(self.lease_ttl / 3)

    def exit(self, completed=True):
        self._stop.set()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=5.0)
        self._status = (ElasticStatus.COMPLETED if completed
                        else ElasticStatus.ERROR)
        self.store.set(f"/elastic/{self.job_id}/exit/{self.rank}",
                       b"ok" if completed else b"err")

    # -- membership -----------------------------------------------------------
    def alive_ranks(self, ranks=None):
        """The ranks among `ranks` (the members when None) whose lease is
        younger than the TTL."""
        now = time.time()
        alive = []
        # the surviving member ids, not range(world): after a shrink the
        # ranks above the new world stay visible
        for r in (self.members if ranks is None else ranks):
            v = self.store.get(self._key(r))
            if v is not None and len(v) == 8:
                if now - struct.unpack("<d", v)[0] < self.lease_ttl:
                    alive.append(r)
        return alive

    def revived_ranks(self):
        """Lost ranks whose lease is fresh again: the candidates for
        re-admission."""
        lost = [r for r in self.all_ranks if r not in self.members]
        return self.alive_ranks(lost)

    def watch(self) -> str:
        """One watch tick (reference manager.py watch): an
        ``ElasticStatus``."""
        if self.store.get(
                f"/elastic/{self.job_id}/exit/{self.rank}") is not None:
            return ElasticStatus.COMPLETED
        revived = self.revived_ranks()
        if revived:
            if self.policy == "rebuild":
                self.readmit(revived)
                return ElasticStatus.HOLD
            return ElasticStatus.RESTART     # relaunch at the grown width
        alive = self.alive_ranks()
        if len(alive) < len(self.members):
            if self.policy == "rebuild":
                from paddle_tpu_torch.distributed import multiproc

                if multiproc.num_processes() > 1:
                    # the survivors' mesh needs new process groups across
                    # the rank processes: only a relaunch makes them
                    warnings.warn("elastic policy='rebuild' requires a "
                                  "single-process runtime; falling back to "
                                  "relaunch")
                    return ElasticStatus.RESTART
                self.rebuild(alive)
                return ElasticStatus.HOLD
            return ElasticStatus.RESTART
        return ElasticStatus.HOLD

    def rebuild(self, alive=None):
        """Shrink the expected world to the surviving members and rebuild
        the mesh over them (growing back needs ``readmit``)."""
        alive = alive if alive is not None else self.alive_ranks()
        old_world = self.world
        self.members = list(alive)
        self.world = max(1, len(alive))
        self._rebuild_mesh()
        if self.on_scale is not None:
            self.on_scale(old_world, self.world)
        self._write_record()
        return self.world

    def _rebuild_mesh(self):
        """Rebuild the rank mesh over this world's ranks, keeping the
        non-dp axes when their product divides the rank count."""
        from paddle_tpu_torch.distributed.env import get_world_size
        from paddle_tpu_torch.distributed.mesh import build_mesh, get_mesh

        mesh = get_mesh()
        n = get_world_size()
        keep = {}
        if mesh is not None:
            keep = {a: int(s) for a, s in mesh.shape.items()
                    if a != "dp" and s > 1}
        prod = 1
        for s in keep.values():
            prod *= s
        if n % prod == 0:
            keep["dp"] = n // prod
            build_mesh(keep)
        else:
            build_mesh({"dp": n})

    def readmit(self, ranks):
        """Re-admit recovered ranks: grow the members back, rebuild the
        mesh, persist the record and call ``on_scale``; the caller then
        reloads its state from the distributed checkpoint at the new
        width (reference manager.py:124, an etcd re-registration and a
        relaunch at the larger world)."""
        old_world = self.world
        self.members = sorted(set(self.members) | set(ranks))
        self.world = len(self.members)
        self._rebuild_mesh()
        if self.on_scale is not None:
            self.on_scale(old_world, self.world)
        self._write_record()
        return self.world

    def should_restart(self) -> bool:
        return self.watch() == ElasticStatus.RESTART
