"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
on the CPU, against the JAX package's launcher.

* The env contract a stdlib-only script sees under either launcher, on
  one node and across two: the same ``PADDLE_*`` names and values apart
  from the session id and the ports; the port adds ``PADDLE_LOCAL_SIZE``
  and drops ``PADDLE_COORDINATOR``.
* Two launchers on one host rendezvous as two nodes at the node-0
  launcher's store (rank 0 then a client of it, over the native wire
  where the native store builds) and run a 2-rank gloo all-reduce.
* Both teardown directions of ``tests/test_multinode_launch.py`` (a
  failure on the remote node, a failure on the store's node), run beside
  the JAX launchers: the same exit codes, the abort read across nodes.
* One node: the first rank to exit non-zero gives the launcher's code;
  a rank that ignores SIGTERM is killed after the grace, and no rank
  outlives the launcher.
* Two gloo CPU ranks train the tiny LLaMA under the launcher at dp 2 with
  ``strategy.recompute`` on the decoder layers: the ranks' losses agree,
  fall, and equal the plain run's bit for bit.

Every wait polls with a bound; the workers are written into tmp_path.
"""
import json
import os
import socket
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DUMP = """\
import json, os, sys
env = {k: v for k, v in os.environ.items() if k.startswith("PADDLE_")}
with open(os.path.join(sys.argv[1], "env." + env["PADDLE_TRAINER_ID"]),
          "w") as fh:
    json.dump(env, fh)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")}
    env.pop("XLA_FLAGS", None)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **extra)
    return env


def _launch(pkg, script, log_dir, *args, nproc=1, nnodes=1, rank=0,
            master=None, job="job", rdzv=60, env=None):
    cmd = [sys.executable, "-m", f"{pkg}.distributed.launch",
           "--nproc_per_node", str(nproc), "--log_dir", str(log_dir),
           "--job_id", job, "--rdzv_timeout", str(rdzv)]
    if nnodes > 1:
        cmd += ["--nnodes", str(nnodes), "--rank", str(rank)]
    if master:
        cmd += ["--master", master]
    return subprocess.Popen(cmd + [str(script), *map(str, args)],
                            env=env or _env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait(procs, timeout=180):
    return [p.communicate(timeout=timeout)[0] for p in procs]


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return path


# ---- the env contract -------------------------------------------------------

@pytest.mark.parametrize("nodes", [1, 2], ids=["one_node", "two_nodes"])
def test_env_contract_matches_jax(tmp_path, nodes):
    script = _write(tmp_path, "dump.py", DUMP)
    procs, outs = [], {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        out = tmp_path / pkg
        out.mkdir()
        outs[pkg] = out
        if nodes == 1:
            procs.append(_launch(pkg, script, out / "log", out, nproc=2))
            continue
        master = f"127.0.0.1:{_free_port()}"
        for r in range(2):
            procs.append(_launch(pkg, script, out / f"log{r}", out, nproc=2,
                                 nnodes=2, rank=r, master=master))
    texts = _wait(procs)
    assert all(p.returncode == 0 for p in procs), texts
    world = 2 * nodes
    envs = {pkg: [json.loads((out / f"env.{r}").read_text())
                  for r in range(world)] for pkg, out in outs.items()}
    for r in range(world):
        jax_env, port_env = envs["paddle_tpu"][r], envs["paddle_tpu_torch"][r]
        assert set(port_env) == set(jax_env) - {"PADDLE_COORDINATOR"} | \
            {"PADDLE_LOCAL_SIZE"}
        assert port_env["PADDLE_LOCAL_SIZE"] == "2"
        same = set(port_env) - {"PADDLE_JOB_SESSION", "PADDLE_MASTER",
                                "PADDLE_LOCAL_SIZE",
                                "PADDLE_TRAINER_ENDPOINTS"}
        assert {k: port_env[k] for k in same} == \
            {k: jax_env[k] for k in same}
        assert port_env["PADDLE_TRAINER_ID"] == str(r)
        assert port_env["PADDLE_LOCAL_RANK"] == str(r % 2)
        assert port_env["PADDLE_TRAINERS_NUM"] == str(world)
        assert port_env["PADDLE_JOB_SESSION"].startswith("job-")
        host, port = port_env["PADDLE_MASTER"].rsplit(":", 1)
        assert host == "127.0.0.1" and int(port) > 0
        if nodes == 2:
            # one endpoint a rank, ports labelled from the master's
            def labels(env):
                m = int(env["PADDLE_MASTER"].rsplit(":", 1)[1])
                return [(h, int(p) - m) for h, p in
                        (e.rsplit(":", 1) for e in
                         env["PADDLE_TRAINER_ENDPOINTS"].split(","))]
            assert labels(port_env) == labels(jax_env)
            assert port_env["PADDLE_JOB_SESSION"] == \
                f"job-{port_env['PADDLE_MASTER']}"
    # every rank of one launch shares the session; one node's differs a
    # launch
    assert len({e["PADDLE_JOB_SESSION"]
                for e in envs["paddle_tpu_torch"]}) == 1


# ---- two nodes on one host --------------------------------------------------

ALLREDUCE = """\
import os, sys
import torch
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import multiproc
from paddle_tpu_torch.distributed.parallel import _STATE

env = dist.init_parallel_env()
t = torch.full((4,), float(env.rank + 1))
dist.all_reduce(t)
names = multiproc.exchange_objects(os.environ["PADDLE_NODE_RANK"])
print("ALLREDUCE", env.rank, env.world_size, t.tolist(), names,
      "native", _STATE["store"].native, flush=True)
dist.destroy_process_group()
"""


def test_two_nodes_rendezvous_and_gloo_allreduce(tmp_path):
    from paddle_tpu_torch.core.native import available

    script = _write(tmp_path, "allreduce.py", ALLREDUCE)
    master = f"127.0.0.1:{_free_port()}"
    procs = [_launch("paddle_tpu_torch", script, tmp_path / f"n{r}",
                     nnodes=2, rank=r, master=master, job="rdzv")
             for r in range(2)]
    outs = _wait(procs)
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "rendezvous complete: 2 nodes" in outs[0]
    for r in range(2):
        log = (tmp_path / f"n{r}" / f"workerlog.{r}").read_text()
        line = [ln for ln in log.splitlines()
                if ln.startswith("ALLREDUCE")]
        assert line, log
        assert line[0].split()[1:4] == [str(r), "2", "[3.0,"]
        assert "['0', '1']" in line[0]
        assert line[0].endswith(f"native {available()}")


# ---- teardown ---------------------------------------------------------------

FAILER = """\
import os, sys, time
rank = int(os.environ["PADDLE_TRAINER_ID"])
with open(os.path.join(sys.argv[1], f"pid.{rank}"), "w") as fh:
    fh.write(str(os.getpid()))
if rank == int(sys.argv[2]):
    time.sleep(float(sys.argv[4]))
    sys.exit(int(sys.argv[3]))
if sys.argv[5:] and rank == int(sys.argv[5]):
    import signal
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
time.sleep(120)
"""


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("failing_node,code", [(1, 7), (0, 5)],
                         ids=["remote_failure", "master_node_failure"])
def test_teardown_across_nodes_matches_jax(tmp_path, failing_node, code):
    """The failing node's rank exits `code`; both nodes' launchers end,
    the other one reading the abort through the store, with the exit
    codes the JAX launchers give in the same run."""
    script = _write(tmp_path, "failer.py", FAILER)
    procs = {}
    t0 = time.monotonic()
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        master = f"127.0.0.1:{_free_port()}"
        pids = tmp_path / f"{pkg}_pids"
        pids.mkdir()
        procs[pkg] = [_launch(pkg, script, tmp_path / f"{pkg}_n{r}", pids,
                              failing_node, code, 1.0, nnodes=2, rank=r,
                              master=master, job="fail")
                      for r in range(2)]
    outs = {pkg: _wait(ps, timeout=120) for pkg, ps in procs.items()}
    codes = {pkg: [p.returncode for p in ps] for pkg, ps in procs.items()}
    assert codes["paddle_tpu_torch"] == codes["paddle_tpu"] == [code, code], \
        outs
    other = 1 - failing_node
    assert "remote node aborted" in outs["paddle_tpu_torch"][other]
    assert f"failed with exit code {code}" in \
        outs["paddle_tpu_torch"][failing_node]
    assert time.monotonic() - t0 < 100
    pids = [int((tmp_path / "paddle_tpu_torch_pids" / f"pid.{r}")
                .read_text()) for r in range(2)]
    assert not any(_alive(p) for p in pids)


def test_one_node_failure_code_and_sigterm_escalation(tmp_path):
    """Rank 2 of 3 exits 7 after a second; rank 1 ignores SIGTERM. The
    launcher returns 7, after killing rank 1 at the grace's end, and no
    rank is left."""
    from paddle_tpu_torch.distributed.launch.main import TERM_GRACE_S

    script = _write(tmp_path, "failer.py", FAILER)
    t0 = time.monotonic()
    proc = _launch("paddle_tpu_torch", script, tmp_path / "log", tmp_path,
                   2, 7, 1.0, 1, nproc=3)
    out = _wait([proc], timeout=120)[0]
    took = time.monotonic() - t0
    assert proc.returncode == 7, out
    assert "rank 2 failed with exit code 7" in out
    assert TERM_GRACE_S <= took < TERM_GRACE_S + 60
    pids = [int((tmp_path / f"pid.{r}").read_text()) for r in range(3)]
    assert not any(_alive(p) for p in pids)
    assert sorted(os.listdir(tmp_path / "log")) == \
        [f"workerlog.{r}" for r in range(3)]


# ---- training under the launcher --------------------------------------------

TRAIN = """\
import json, os, sys
import numpy as np
import torch
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import fleet, multiproc
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep

torch.set_num_threads(1)
env = dist.init_parallel_env()
strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = {"dp_degree": 2}
strategy.recompute = True
strategy.recompute_configs = {"checkpoints": ["llama.layers."]}
hcg = fleet.init(strategy=strategy)
cfg = llama_tiny_config(num_key_value_heads=2, num_hidden_layers=2)
ids = np.random.RandomState(0).randint(1, 256, (2, 33))
batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def run(recompute):
    # TrainStep(mesh=) builds its own strategy and hcg: the recompute
    # strategy's passes go first, through distributed_model
    model = LlamaForCausalLM(cfg, device="cpu", seed=1)
    wrapper, mesh = model, hcg.mesh
    if recompute:
        mesh = fleet.init(strategy=strategy).mesh
        wrapper = fleet.distributed_model(model)
    wrapped = sorted(n for n, m in model.named_modules()
                     if getattr(m, "_recompute_wrapped", False))
    opt = AdamW(learning_rate=1e-2, parameters=model.parameters())
    step = TrainStep(wrapper, lambda out, lab: out, opt, mesh=mesh)
    return [float(step(batch)) for _ in range(3)], wrapped


plain, none = run(False)
rc, wrapped = run(True)
losses = multiproc.exchange_objects(rc)
print("TRAIN", json.dumps({"rank": env.rank, "plain": plain, "rc": rc,
                           "wrapped": wrapped, "none": none,
                           "all": losses}), flush=True)
dist.destroy_process_group()
"""


def test_launcher_trains_tiny_llama_with_recompute(tmp_path):
    script = _write(tmp_path, "train.py", TRAIN)
    proc = _launch("paddle_tpu_torch", script, tmp_path / "log", nproc=2)
    out = _wait([proc], timeout=300)[0]
    logs = [(tmp_path / "log" / f"workerlog.{r}").read_text()
            for r in range(2)]
    assert proc.returncode == 0, (out, logs)
    res = [json.loads(next(ln for ln in log.splitlines()
                           if ln.startswith("TRAIN "))[6:]) for log in logs]
    for r, got in enumerate(res):
        assert got["rank"] == r
        assert got["none"] == []
        assert got["wrapped"] == ["llama.layers.0", "llama.layers.1"]
        assert got["rc"] == got["plain"]          # bit for bit
        assert got["rc"][-1] < got["rc"][0]
        assert got["all"] == [res[0]["rc"], res[1]["rc"]]
    assert res[0]["rc"] == res[1]["rc"]           # dp ranks agree
