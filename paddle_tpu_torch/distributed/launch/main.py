"""The distributed launcher (``paddle_tpu.distributed.launch``
counterpart; reference: python/paddle/distributed/launch/main.py:21 and
controllers/collective.py, master.py, watcher.py).

``python -m paddle_tpu_torch.distributed.launch [--nnodes N --rank R
--master host:port] --nproc_per_node P --log_dir D --job_id J
--rdzv_timeout T script args...`` starts P processes of the script on
this node, one a rank, each with the launch contract in its environment
and its output in ``<log_dir>/workerlog.<rank>``:

- ``PADDLE_TRAINER_ID`` (global rank), ``PADDLE_LOCAL_RANK``,
  ``PADDLE_TRAINERS_NUM`` (N x P), ``PADDLE_JOB_ID``,
  ``PADDLE_JOB_SESSION`` (the store keys' namespace: fresh a launch on one
  node, derived from the job and the master across nodes), and
  ``PADDLE_MASTER`` (host:port of the job's TCPStore; a free loopback
  port on one node with more than one rank);
- across nodes also ``PADDLE_TRAINER_ENDPOINTS`` (one a rank) and
  ``PADDLE_NODE_RANK``;
- ``PADDLE_LOCAL_SIZE``, P: the ranks sharing this node, from which
  ``init_parallel_env`` picks gloo for ranks that share a card. The JAX
  package's launcher sets ``PADDLE_COORDINATOR`` (the address of
  ``jax.distributed``) instead, which nothing in the port reads.

Across nodes the node-0 launcher hosts the job's TCPStore on ``--master``
for the whole run (rank 0 then joins it as a client): every node
registers there and waits for all N, and the store carries the abort.

The watcher: the first rank to exit non-zero ends this node's group and
posts its code as the abort; every node's launcher that reads it ends its
own group. Ending a group sends SIGTERM, waits up to ``TERM_GRACE_S`` and
then sends SIGKILL to a rank still alive (the JAX package's launcher
sends SIGTERM and does not wait), so no rank outlives its launcher on the
card. A clean node waits on the job's ``done`` counter for the other
nodes. The launcher exits with the failing rank's code; like the JAX
package's, it does not relaunch on ``ELASTIC_EXIT_CODE``.
"""
from __future__ import annotations

import argparse
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

__all__ = ["launch", "main", "TERM_GRACE_S", "ABORT_GRACE_S"]

TERM_GRACE_S = 10.0     # SIGTERM to SIGKILL
ABORT_GRACE_S = 10.0    # node 0 keeps the store up for the others to read
POLL_S = 0.2            # the watcher's tick


def _parse_args(argv):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nnodes", type=int, default=1, help="number of nodes")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes (ranks) on this node")
    p.add_argument("--master", type=str, default=None,
                   help="rendezvous host:port")
    p.add_argument("--rank", type=int,
                   default=int(os.getenv("PADDLE_NODE_RANK", "0")),
                   help="this node's rank")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--rdzv_timeout", type=float, default=300.0,
                   help="seconds to wait for every node at the master")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _rendezvous(args):
    """The multi-node rendezvous (reference controllers/master.py): the
    node-0 launcher hosts the job's TCPStore; every node registers its
    host name and waits until all ``--nnodes`` are there."""
    from paddle_tpu_torch.distributed.store import TCPStore

    host, port = args.master.rsplit(":", 1)
    store = TCPStore(host, int(port), is_master=(args.rank == 0),
                     world_size=args.nnodes, timeout=args.rdzv_timeout)
    pre = f"launch/{args.job_id}"
    store.set(f"{pre}/node/{args.rank}", socket.gethostname().encode())
    peers = [store.wait(f"{pre}/node/{r}").decode()
             for r in range(args.nnodes)]
    print(f"rendezvous complete: {args.nnodes} nodes {peers}",
          file=sys.stderr, flush=True)
    return store, pre, peers


def _rank_env(args, rank, local, world, peers):
    env = dict(os.environ)
    env.pop("PADDLE_COORDINATOR", None)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_LOCAL_RANK": str(local),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_SIZE": str(args.nproc_per_node),
        "PADDLE_JOB_ID": args.job_id,
        # one node: a fresh session a launch (an earlier launch's keys
        # are dead); across nodes the launchers must agree, so it comes
        # from the job (an operator may set it)
        "PADDLE_JOB_SESSION": os.getenv(
            "PADDLE_JOB_SESSION",
            f"{args.job_id}-{os.getpid()}-{int(time.time())}"
            if args.nnodes == 1
            else f"{args.job_id}-{args.master or 'nomaster'}"),
    })
    if args.master:
        env["PADDLE_MASTER"] = args.master
    if peers is not None:
        # one endpoint a rank: its node's host, a port label derived from
        # the master's (the ranks run no listening service at it)
        mport = int(args.master.rsplit(":", 1)[1])
        env["PADDLE_TRAINER_ENDPOINTS"] = ",".join(
            f"{peers[r // args.nproc_per_node]}:{mport + 10 + r}"
            for r in range(world))
        env["PADDLE_NODE_RANK"] = str(args.rank)
    return env


def _end_group(procs) -> None:
    """SIGTERM every live rank, then SIGKILL what is alive after
    TERM_GRACE_S, and reap them all."""
    live = [p for p, _, _ in procs if p.poll() is None]
    for p in live:
        p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + TERM_GRACE_S
    for p in live:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _abort_seen(store, pre) -> None:
    try:
        store.add(f"{pre}/aborted", 1)
    except (ConnectionError, OSError):
        pass


def launch(argv=None) -> int:
    """Run the launcher; returns the job's exit code."""
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    os.makedirs(args.log_dir, exist_ok=True)
    nproc = args.nproc_per_node
    world = args.nnodes * nproc
    store, pre, peers = None, None, None
    if args.nnodes > 1:
        if not args.master:
            print("--master host:port is required when --nnodes > 1",
                  file=sys.stderr)
            return 2
        store, pre, peers = _rendezvous(args)
    elif world > 1 and not args.master:
        from paddle_tpu_torch.distributed.spawn import free_port

        args.master = f"127.0.0.1:{free_port()}"
    procs = []
    for local in range(nproc):
        rank = args.rank * nproc + local
        log = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
        cmd = [sys.executable, args.training_script] + \
            args.training_script_args
        procs.append((subprocess.Popen(
            cmd, env=_rank_env(args, rank, local, world, peers), stdout=log,
            stderr=subprocess.STDOUT), log, rank))

    # one waiter thread a rank reports its exit, so the first rank to
    # fail is the first reported, whatever the others do after it
    exits: queue.Queue = queue.Queue()
    for p, _, rank in procs:
        threading.Thread(target=lambda p=p, r=rank: exits.put((r, p.wait())),
                         daemon=True, name=f"launch.waiter.{rank}").start()
    exit_code = 0
    try:
        finished = 0
        while finished < len(procs):
            try:
                rank, code = exits.get(timeout=POLL_S)
            except queue.Empty:
                if store is None:
                    continue
                try:
                    remote = store.get(f"{pre}/abort")
                except (ConnectionError, OSError):
                    # the node-0 store died: the job is over either way
                    remote = b"1"
                if remote:
                    exit_code = int(remote.decode() or 1)
                    print(f"remote node aborted (exit {exit_code}); "
                          "terminating", file=sys.stderr, flush=True)
                    _abort_seen(store, pre)
                    break
                continue
            if code == 0:
                finished += 1
                continue
            exit_code = code
            print(f"rank {rank} failed with exit code {code}; terminating "
                  "group", file=sys.stderr, flush=True)
            if store is not None:
                try:
                    store.set(f"{pre}/abort", str(code).encode())
                except (ConnectionError, OSError):
                    pass
                _abort_seen(store, pre)
            break
    finally:
        _end_group(procs)
        for _, log, _ in procs:
            log.close()
    if store is not None:
        exit_code = _drain(args, store, pre, exit_code)
        store.close()
    return exit_code


def _drain(args, store, pre, exit_code) -> int:
    """After this node's group ended; returns the job's exit code. On a
    failure node 0 keeps the store it hosts up until every node has seen
    the abort (at most ABORT_GRACE_S). On a clean finish every node waits
    until all report done (node 0 keeping the store up for them); an
    abort posted meanwhile is the job's code."""
    try:
        if exit_code != 0:
            if args.rank == 0:
                deadline = time.monotonic() + min(ABORT_GRACE_S,
                                                  args.rdzv_timeout)
                while time.monotonic() < deadline and \
                        store.add(f"{pre}/aborted", 0) < args.nnodes:
                    time.sleep(POLL_S)
            return exit_code
        store.add(f"{pre}/done", 1)
        deadline = time.monotonic() + args.rdzv_timeout
        while time.monotonic() < deadline:
            if store.add(f"{pre}/done", 0) >= args.nnodes:
                return 0
            remote = store.get(f"{pre}/abort")
            if remote:
                return int(remote.decode() or 1)
            time.sleep(POLL_S)
    except (ConnectionError, OSError):
        pass
    return exit_code


def main():
    # a SIGTERM to the launcher ends its ranks too (the ``finally`` of
    # ``launch``), so none outlives it on the card
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    sys.exit(launch())


if __name__ == "__main__":
    main()
