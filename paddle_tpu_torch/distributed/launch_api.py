"""``spawn``: run a function on ``nprocs`` ranks, one process each (the
counterpart of ``paddle_tpu/distributed/launch_api.py``).

The JAX package runs one controller per host, so its ``spawn`` mostly
calls the function in place.  The port runs one process per rank, as
Paddle's ``paddle.distributed.spawn`` does: each rank starts from a fresh
interpreter (the ``spawn`` start method; a card cannot be forked) with
the launcher's environment contract set:

 - ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``;
 - ``PADDLE_TRAINER_ENDPOINTS`` and ``PADDLE_CURRENT_ENDPOINT``;
 - the rendezvous of :func:`.parallel.init_parallel_env`: a file store
   at ``store`` (``PT_STORE_FILE``), or ``MASTER_ADDR`` / ``MASTER_PORT``
   on a free localhost port.

The arguments reach the ranks, and each rank returns its function's
result to the parent, through files in a temporary directory (so large
data never blocks a pipe, and a rank importing its function's module
never holds up the next rank's start).  The
parent fails when any rank exits non-zero (the others are stopped, and
the error names the rank and carries its traceback) or when the ranks
have not all finished within ``timeout`` seconds (all are stopped).
"""
from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import pickle
import shutil
import socket
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait as _wait_sentinels
from typing import Any, Callable, Dict, List, Optional

__all__ = ["spawn", "launch", "SpawnContext"]

_STOP_GRACE_S = 5.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _environ(env: Dict[str, str]):
    """``os.environ`` with ``env`` set, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _worker(func, rank, env, out_dir):
    os.environ.update(env)
    path = os.path.join(out_dir, f"rank{rank}")
    code = 0
    try:
        with open(os.path.join(out_dir, "args"), "rb") as f:
            args = pickle.load(f)
        result = func(*args)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path + ".out")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # no teardown: a rank whose gloo peers have already gone can abort
    # in the process group's destructors (std::terminate) after its
    # result is written; the operating system closes its connections
    os._exit(code)


class SpawnContext:
    """The started ranks: :meth:`join` waits for them and returns each
    rank's result, in rank order."""

    def __init__(self, procs: List[mp.Process], out_dir: str):
        self.processes = procs
        self._out_dir = out_dir

    def _stop(self, procs) -> None:
        for p in procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + _STOP_GRACE_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()

    def _error(self, rank: int) -> str:
        path = os.path.join(self._out_dir, f"rank{rank}.err")
        if os.path.exists(path):
            with open(path) as f:
                return f.read()
        return "(no traceback: the process was killed or exited by itself)"

    def join(self, timeout: Optional[float] = None) -> List[Any]:
        """Wait for every rank; return their results.  Raises
        ``RuntimeError`` when a rank fails and ``TimeoutError`` past
        ``timeout`` seconds; either way every rank is stopped."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            live = list(self.processes)
            while live:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"spawn: ranks {[self.processes.index(p) for p in live]}"
                        f" did not finish within {timeout} s")
                _wait_sentinels([p.sentinel for p in live], left)
                for p in [p for p in live if p.exitcode is not None]:
                    live.remove(p)
                    if p.exitcode != 0:
                        rank = self.processes.index(p)
                        raise RuntimeError(
                            f"spawn: rank {rank} exited with code "
                            f"{p.exitcode}:\n{self._error(rank)}")
            results = []
            for rank in range(len(self.processes)):
                with open(os.path.join(self._out_dir, f"rank{rank}.out"),
                          "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            self._stop(self.processes)
            shutil.rmtree(self._out_dir, ignore_errors=True)


def spawn(func: Callable, args=(), nprocs: int = 1, join: bool = True,
          daemon: bool = False, *, timeout: Optional[float] = None,
          store: Optional[str] = None, **options):
    """Run ``func(*args)`` on ``nprocs`` ranks, each in its own process.

    ``func`` must be importable by name (a module-level function).  A
    rank joins the process group by calling ``init_parallel_env``, which
    reads the environment set here: ``store`` (a path that does not exist
    yet) for a ``torch.distributed`` file store, else a free localhost
    port.  With more than one rank, ``OMP_NUM_THREADS`` is 1 unless set.
    With ``join``, waits up
    to ``timeout`` seconds and returns the ranks' results in rank order
    (:meth:`SpawnContext.join`); else returns the :class:`SpawnContext`.
    ``options`` (Paddle's ``backend``, ``ips``, ...) are accepted and
    ignored: the backend is ``init_parallel_env``'s."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be at least 1, got {nprocs}")
    base = {}
    if nprocs > 1 and "OMP_NUM_THREADS" not in os.environ:
        # one intra-op thread a rank unless told otherwise, as
        # torch.distributed.run does: ranks that each take every core
        # slow a host to a crawl
        base["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    eps = [f"127.0.0.1:{port + i}" for i in range(nprocs)]
    base.update(PADDLE_TRAINERS_NUM=str(nprocs),
                PADDLE_TRAINER_ENDPOINTS=",".join(eps),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if store is not None:
        if os.path.exists(store):
            raise ValueError(f"spawn: the store file {store} exists; a file "
                             f"store needs a new path each run")
        base["PT_STORE_FILE"] = os.path.abspath(store)
    ctx = mp.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="pt_spawn_")
    procs = []
    try:
        # the arguments go through a file: through the start pipe, a rank
        # still importing ``func``'s module would hold up the next start
        with open(os.path.join(out_dir, "args"), "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
        for rank in range(nprocs):
            renv = dict(base, PADDLE_TRAINER_ID=str(rank),
                        PADDLE_LOCAL_RANK=str(rank),
                        PADDLE_CURRENT_ENDPOINT=eps[rank])
            p = ctx.Process(target=_worker,
                            args=(func, rank, renv, out_dir),
                            daemon=daemon)
            with _environ(renv):       # read while the child starts
                p.start()
            procs.append(p)
    except BaseException:
        SpawnContext(procs, out_dir)._stop(procs)
        shutil.rmtree(out_dir, ignore_errors=True)
        raise
    context = SpawnContext(procs, out_dir)
    if not join:
        return context
    return context.join(timeout)


def launch():
    """The launcher's command line (``python -m
    paddle_tpu_torch.distributed.launch``) on ``sys.argv``; exits with its
    code."""
    from .launch.main import main
    sys.exit(main())
