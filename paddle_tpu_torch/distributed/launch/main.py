"""The multi-process launcher: ``python -m paddle_tpu_torch.distributed.launch``
(the counterpart of ``paddle_tpu/distributed/launch/main.py``).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 train.py --lr 0.1
    python -m paddle_tpu_torch.distributed.launch --devices 0,1 train.py
    python -m paddle_tpu_torch.distributed.launch --nnodes 2 --rank 0 \\
        --master 10.0.0.1:6170 --nproc_per_node 8 train.py

The port runs one process per rank, as Paddle's launcher does: this
starts ``--nproc_per_node`` copies of the training script on this node,
each with the reference's environment contract, which the port's
:mod:`..env` and :func:`..parallel.init_parallel_env` read:

 - ``PADDLE_TRAINER_ID`` (the global rank: ``node_rank * nproc +
   local_rank``), ``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``,
   ``PADDLE_LOCAL_SIZE``, ``PADDLE_NNODES``, ``PADDLE_JOB_ID``;
 - ``MASTER_ADDR`` / ``MASTER_PORT``: ``--master`` when given, else
   ``127.0.0.1`` and one free port, drawn once a launch, so every rank
   meets at the same store;
 - ``PADDLE_TRAINER_ENDPOINTS`` (``MASTER_ADDR:MASTER_PORT + i`` for rank
   ``i``) and ``PADDLE_CURRENT_ENDPOINT``, this rank's;
 - with ``--devices`` (the card ids of this node, ``0,1``):
   ``CUDA_VISIBLE_DEVICES`` set to them and ``FLAGS_selected_gpus`` to
   the one local rank ``i`` drives, the ``i``-th
   (``init_parallel_env`` puts local rank ``i`` on visible card ``i``).

Rank ``r`` writes its output to ``<log_dir>/workerlog.<r>``.  When a rank
exits with a code other than 0, the others are stopped and the launch
fails with that rank's code, after printing the end of its log; with
``--max_restart n`` the whole node is started again up to ``n`` times
first.  SIGTERM stops every rank.

``--elastic``, ``--with_store`` and ``--min_world`` (supervised, elastic
runs) need the supervisor and the resilient store, which the port does
not have yet: each raises.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["main", "launch", "parse_args", "build_env"]

#: what the unported options need
_ELASTIC = ("the supervisor and the resilient store "
            "(distributed/supervisor.py, resilient_store.py) are not "
            "ported: ROADMAP Queue 1 item 6")
#: lines of a failed rank's log printed at the end
_TAIL_LINES = 20
#: seconds a stopped rank has to exit before it is killed
_STOP_GRACE_S = 5.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="paddle_tpu_torch distributed launcher: one process "
                    "per rank")
    p.add_argument("--master", default=None,
                   help="rendezvous endpoint host:port (a free local port "
                        "when unset; needed with more than one node)")
    p.add_argument("--rank", type=int, default=-1,
                   help="node rank; -1 = auto (single node: 0)")
    p.add_argument("--nnodes", default="1",
                   help="number of nodes (elastic ranges 'lo:hi' collapse "
                        "to lo)")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="ranks on this node (default: the number of "
                        "--devices, else 1)")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--log_level", default="INFO")
    p.add_argument("--job_id", default="default")
    p.add_argument("--devices", default=None,
                   help="card ids of this node, e.g. 0,1: local rank i "
                        "drives the i-th")
    p.add_argument("--run_mode", default="collective")
    p.add_argument("--max_restart", type=int, default=0)
    p.add_argument("--elastic", action="store_true",
                   help="supervised elastic run (not ported)")
    p.add_argument("--with_store", action="store_true",
                   help="(elastic) a standby store (not ported)")
    p.add_argument("--min_world", type=int, default=None,
                   help="(elastic) smallest world size (not ported)")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _devices(args) -> list:
    return [d.strip() for d in str(args.devices).split(",") if d.strip()] \
        if args.devices else []


def _nproc(args) -> int:
    if args.nproc_per_node is not None:
        return args.nproc_per_node
    return len(_devices(args)) or 1


def _master(args) -> tuple:
    """``(addr, port)`` of the rendezvous, drawn once a launch."""
    if args.master:
        host, _, port = args.master.rpartition(":")
        return host, int(port)
    return "127.0.0.1", _free_port()


def build_env(args, local_rank: int, nnodes: int, master: tuple) -> dict:
    """The environment of local rank ``local_rank`` (module docstring);
    ``master``: :func:`_master`'s ``(addr, port)``, the same for every
    rank of the launch."""
    nproc = _nproc(args)
    world = nnodes * nproc
    rank = max(args.rank, 0) * nproc + local_rank
    addr, port = master
    endpoints = [f"{addr}:{port + i}" for i in range(world)]
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_LOCAL_SIZE": str(nproc),
        "PADDLE_NNODES": str(nnodes),
        "PADDLE_JOB_ID": args.job_id,
        "MASTER_ADDR": addr,
        "MASTER_PORT": str(port),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
    })
    devs = _devices(args)
    if devs:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(devs)
        env["FLAGS_selected_gpus"] = devs[local_rank % len(devs)]
    if nproc > 1 and "OMP_NUM_THREADS" not in os.environ:
        # one intra-op thread a rank unless told otherwise (as spawn)
        env["OMP_NUM_THREADS"] = "1"
    return env


def _stop(procs) -> None:
    for pr in procs:
        if pr.poll() is None:
            pr.terminate()
    deadline = time.monotonic() + _STOP_GRACE_S
    for pr in procs:
        try:
            pr.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pr.kill()
            pr.wait()


def _run_once(args, nnodes: int) -> tuple:
    """Start this node's ranks and wait for them: ``(0, None)`` when all
    exit 0, else ``(code, rank)`` of the first to fail (the others
    stopped)."""
    os.makedirs(args.log_dir, exist_ok=True)
    master = _master(args)
    cmd = [sys.executable, "-u", args.training_script,
           *args.training_script_args]
    procs, logs, ranks = [], [], []
    stopping = []

    def _on_term(*_):
        stopping.append(True)
        _stop(procs)

    old = signal.signal(signal.SIGTERM, _on_term)
    try:
        for lr in range(_nproc(args)):
            env = build_env(args, lr, nnodes, master)
            rank = int(env["PADDLE_TRAINER_ID"])
            logf = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
            logs.append(logf)
            ranks.append(rank)
            procs.append(subprocess.Popen(cmd, env=env, stdout=logf,
                                          stderr=subprocess.STDOUT))
        while True:
            codes = [pr.poll() for pr in procs]
            bad = [(c, r) for c, r in zip(codes, ranks) if c not in (None, 0)]
            if bad:
                _stop(procs)
                code, rank = bad[0]
                # killed by a signal: the shell's 128 + signal number
                return (128 - code if code < 0 else code), rank
            if all(c == 0 for c in codes):
                return 0, None
            if stopping:
                return 143, None
            time.sleep(0.2)
    finally:
        _stop(procs)
        signal.signal(signal.SIGTERM, old)
        for f in logs:
            f.close()


def _tail(args, rank) -> str:
    if rank is None:
        return ""
    try:
        with open(os.path.join(args.log_dir, f"workerlog.{rank}")) as f:
            return "".join(f.readlines()[-_TAIL_LINES:])
    except OSError:
        return ""


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.elastic or args.with_store or args.min_world is not None:
        raise NotImplementedError(
            f"--elastic, --with_store and --min_world: {_ELASTIC}")
    nnodes = int(str(args.nnodes).split(":")[0])
    if nnodes > 1 and not args.master:
        raise ValueError(f"--nnodes {nnodes} needs --master host:port, the "
                         f"rendezvous every node reaches")
    if nnodes > 1 and not 0 <= args.rank < nnodes:
        raise ValueError(f"--nnodes {nnodes} needs --rank in [0, {nnodes})")
    restarts = 0
    while True:
        code, rank = _run_once(args, nnodes)
        if code == 0:
            return 0
        restarts += 1
        if restarts > args.max_restart or rank is None:
            where = "" if rank is None else f"rank {rank} "
            print(f"launch: worker {where}exited with code {code}\n"
                  f"{_tail(args, rank)}", file=sys.stderr)
            return code
        print(f"launch: rank {rank} exited with code {code}; restarting "
              f"({restarts}/{args.max_restart})", file=sys.stderr)


def launch():
    sys.exit(main())
