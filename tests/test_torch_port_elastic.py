"""The port's elastic manager (``fleet.elastic``) and filesystem
abstraction (``fleet.utils.fs``) against the JAX package's, on the CPU.

* The scenarios of ``tests/test_aux_subsystems.py`` (register, watch,
  restart; the rebuild shrink with a middle rank lost; a lost rank's
  re-admission with a resume from the distributed checkpoint; a lost
  member under the relaunch policy) driven on both packages' managers,
  each on its own package's TCPStore: the same ``watch()`` sequence, the
  same members, worlds, ``on_scale`` calls and rendezvous records. The
  JAX manager rebuilds its device mesh (8 CPU devices, mp kept); the
  port's rebuilds the ``RankMesh`` of its world of one by the same rule.
  In a multi-process world the port's rebuild falls back to RESTART.
  Leases are stamped directly (stale ones 10 s old), so no case waits on
  a clock.
* ``LocalFS`` against JAX's on the same tree operations, results and
  errors; ``HDFSClient`` without the hadoop CLI raises in both.
"""
import struct
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.distributed.fleet import elastic as jax_elastic
from paddle_tpu.distributed.fleet.utils import fs as jax_fs
from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu_torch.distributed import mesh as port_mesh
from paddle_tpu_torch.distributed.fleet import elastic as port_elastic
from paddle_tpu_torch.distributed.fleet.utils import fs as port_fs
from paddle_tpu_torch.distributed.store import TCPStore as PortStore

PACKAGES = {"jax": (jax_elastic, JaxStore, jax_mesh),
            "port": (port_elastic, PortStore, port_mesh)}


@pytest.fixture
def stores():
    opened = {name: store(is_master=True) for name, (_, store, _)
              in PACKAGES.items()}
    yield opened
    for s in opened.values():
        s.close()
    jax_mesh.set_mesh(None)
    port_mesh.set_mesh(None)


def _stamp(store, job, rank, age_s=0.0):
    store.set(f"/elastic/{job}/lease/{rank}",
              struct.pack("<d", time.time() - age_s))


def _both(stores, job, world, **kw):
    """A manager of each package, rank 0 of `world`, and their scales."""
    out = {}
    for name, (mod, _, _) in PACKAGES.items():
        scales = []
        mgr = mod.ElasticManager(store=stores[name], rank=0,
                                 world_size=world, lease_ttl=1.0, job_id=job,
                                 on_scale=lambda o, n, s=scales: s.append(
                                     (o, n)), **kw)
        out[name] = (mgr, scales)
    return out


def test_register_watch_restart_hold_complete(stores):
    """Rank 1 never registered: RESTART; once it holds a lease: HOLD;
    after exit: COMPLETED."""
    seqs = {}
    for name, (mod, store, _) in PACKAGES.items():
        mgr = mod.ElasticManager(store=stores[name], rank=0, world_size=2,
                                 lease_ttl=1.0)
        mgr.register()
        seq = [mgr.watch()]
        client = store("127.0.0.1", stores[name].port, is_master=False)
        peer = mod.ElasticManager(store=client, rank=1, world_size=2,
                                  lease_ttl=1.0)
        peer.register()
        seq.append(mgr.watch())
        peer.exit(completed=True)
        mgr.exit(completed=True)
        seq.append(mgr.watch())
        seqs[name] = (seq, mgr.read_record())
        client.close()
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][0] == [port_elastic.ElasticStatus.RESTART,
                               port_elastic.ElasticStatus.HOLD,
                               port_elastic.ElasticStatus.COMPLETED]
    assert port_elastic.ELASTIC_EXIT_CODE == \
        jax_elastic.ELASTIC_EXIT_CODE == 101


def test_relaunch_policy_restarts_on_a_lost_member(stores):
    mgrs = _both(stores, "relaunch", 3)
    seqs = {}
    for name, (mgr, _) in mgrs.items():
        for r in range(3):
            _stamp(stores[name], "relaunch", r)
        seq = [mgr.watch()]
        _stamp(stores[name], "relaunch", 2, age_s=10)
        seq += [mgr.watch(), mgr.should_restart()]
        seqs[name] = (seq, mgr.members, mgr.world, mgr.read_record())
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][0] == ["hold", "restart", True]


def test_rebuild_shrinks_world_and_mesh(stores):
    """A middle rank's lease expires: the world shrinks to the survivors
    (rank 2 stays visible), the mesh is rebuilt, no restart; the next
    ticks hold."""
    jax_mesh.build_mesh({"mp": 2, "dp": 4})
    port_mesh.build_mesh({"dp": 1})
    mgrs = _both(stores, "reb", 3, policy="rebuild")
    seqs = {}
    for name, (mgr, scales) in mgrs.items():
        for r in range(3):
            _stamp(stores[name], "reb", r)
        seq = [mgr.watch()]
        _stamp(stores[name], "reb", 1, age_s=10)
        seq.append(mgr.watch())
        _stamp(stores[name], "reb", 0)
        _stamp(stores[name], "reb", 2)
        seq.append(mgr.watch())
        seqs[name] = (seq, mgr.members, mgr.world, list(scales),
                      mgr.read_record())
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][:4] == (["hold"] * 3, [0, 2], 2, [(3, 2)])
    assert int(jax_mesh.get_mesh().shape["mp"]) == 2
    assert port_mesh.get_mesh().shape == {"dp": 1}


def test_rebuild_in_a_multi_process_world_restarts(stores, monkeypatch):
    """A process a rank: the survivors' mesh needs new process groups,
    so the rebuild falls back to RESTART with a warning (the JAX
    package's fallback for more than one process)."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    mgr = port_elastic.ElasticManager(store=stores["port"], rank=0,
                                      world_size=2, lease_ttl=1.0,
                                      job_id="multi", policy="rebuild")
    _stamp(stores["port"], "multi", 0)
    _stamp(stores["port"], "multi", 1, age_s=10)
    with pytest.warns(UserWarning, match="single-process"):
        assert mgr.watch() == port_elastic.ElasticStatus.RESTART
    assert mgr.members == [0, 1] and mgr.world == 2


def test_readmission_resumes_full_width(stores, tmp_path):
    """Rank 1 dies (rebuild over rank 0), re-registers, and the next tick
    re-admits it; training state reloads from the distributed checkpoint
    written before the failure."""
    import paddle_tpu as jpaddle
    import paddle_tpu.distributed.checkpoint as jckpt
    import paddle_tpu_torch.distributed.checkpoint as tckpt

    jax_mesh.build_mesh({"dp": 8})
    port_mesh.build_mesh({"dp": 1})
    mgrs = _both(stores, "readm", 2, policy="rebuild")
    seqs = {}
    for name, (mgr, scales) in mgrs.items():
        mod = PACKAGES[name][0]
        for r in range(2):
            _stamp(stores[name], "readm", r)
        seq = [mgr.watch(), mgr.read_record()]
        _stamp(stores[name], "readm", 1, age_s=10)
        seq += [mgr.watch(), mgr.members, mgr.read_record()]
        back = mod.ElasticManager(store=stores[name], rank=1, world_size=2,
                                  lease_ttl=1.0, job_id="readm",
                                  policy="rebuild")
        back.register()
        seq += [mgr.watch(), mgr.members, mgr.world, mgr.read_record(),
                list(scales)]
        back.exit()
        mgr.exit()
        seqs[name] = seq
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][-1] == [(2, 1), (1, 2)]
    assert seqs["port"][-2]["members"] == [0, 1]

    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    jckpt.save_state_dict({"w": jpaddle.to_tensor(w)}, str(tmp_path / "j"))
    tckpt.save_state_dict({"w": torch.from_numpy(w.copy())},
                          str(tmp_path / "t"))
    for src in ("j", "t"):
        loaded = {"w": torch.zeros(8, 8)}
        tckpt.load_state_dict(loaded, str(tmp_path / src))
        assert np.array_equal(loaded["w"].numpy(), w)


# ---- fs -------------------------------------------------------------------

def _fs_ops(fs, root):
    """A fixed sequence of tree operations; each op's result, or the
    exception type it raised, and the tree after it."""
    import os

    def p(*parts):
        return os.path.join(root, *parts)

    ops = [
        ("ls_missing", lambda: fs.ls_dir(p("nope"))),
        ("mkdirs", lambda: fs.mkdirs(p("a", "b"))),
        ("mkdirs_again", lambda: fs.mkdirs(p("a", "b"))),
        ("touch", lambda: fs.touch(p("a", "f.txt"))),
        ("touch_exists_ok", lambda: fs.touch(p("a", "f.txt"))),
        ("touch_exists", lambda: fs.touch(p("a", "f.txt"), exist_ok=False)),
        ("ls", lambda: fs.ls_dir(p("a"))),
        ("kinds", lambda: (fs.is_file(p("a", "f.txt")), fs.is_dir(p("a")),
                           fs.is_exist(p("a", "zz")))),
        ("upload_file", lambda: fs.upload(p("a", "f.txt"),
                                          p("c", "g.txt"))),
        ("upload_tree", lambda: fs.upload(p("a"), p("d", "a"))),
        ("download_overwrite", lambda: fs.download(p("a"), p("d", "a"),
                                                   overwrite=True)),
        ("mv_exists", lambda: fs.mv(p("c", "g.txt"), p("a", "f.txt"))),
        ("mv_overwrite", lambda: fs.mv(p("c", "g.txt"), p("a", "f.txt"),
                                       overwrite=True)),
        ("mv", lambda: fs.mv(p("a", "b"), p("e"))),
        ("delete_file", lambda: fs.delete(p("a", "f.txt"))),
        ("delete_tree", lambda: fs.delete(p("d"))),
        ("delete_missing", lambda: fs.delete(p("nope"))),
    ]
    out = []
    for name, op in ops:
        try:
            res = op()
        except Exception as e:          # the error is the result compared
            res = type(e).__name__
        tree = sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, ds, fs_ in os.walk(root) for f in ds + fs_)
        out.append((name, res, tree))
    return out


def test_localfs_matches_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _fs_ops(jax_fs.LocalFS(), str(tmp_path / "jax"))
    got = _fs_ops(port_fs.LocalFS(), str(tmp_path / "port"))
    assert got == want
    assert dict((n, r) for n, r, _ in got)["touch_exists"] == \
        "FileExistsError"


def test_hdfs_client_needs_hadoop(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    for mod in (jax_fs, port_fs):
        with pytest.raises(RuntimeError, match="hadoop"):
            mod.HDFSClient(hadoop_home=str(tmp_path))
    assert issubclass(port_fs.LocalFS, port_fs.FS)
