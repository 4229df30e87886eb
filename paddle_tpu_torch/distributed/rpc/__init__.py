"""``paddle.distributed.rpc`` (the counterpart of
``paddle_tpu/distributed/rpc/__init__.py``): call a function on another
worker of the job.

Each worker runs an agent: a threaded TCP server that reads a request
(a length-prefixed pickle of ``(fn, args, kwargs)``), calls it and sends
back ``("ok", result)`` or ``("err", exception)`` the same way.  A
request is a pickled callable run on the target, so the agents trust
each other, as the reference's transport does: the ranks of one job.
Callables go through ``cloudpickle`` where it is installed (lambdas and
closures), else ``pickle`` (functions importable by name).

The agent binds the address it publishes: the host of
``PADDLE_CURRENT_ENDPOINT`` (the launcher's), else ``127.0.0.1``, on a
free port.  The workers meet through a ``torch.distributed.TCPStore`` at
``master_endpoint`` (``PADDLE_MASTER_ENDPOINT`` when not given; rank 0
hosts it), or, when neither is set and a process group is up, through
the process group's own store.  Each publishes ``(name, rank, ip,
port)``; ``init_rpc`` returns when every worker has read the table, and
``shutdown`` waits for every worker before stopping the agent, so no
agent stops while another may still call it.

``timeout`` (seconds) bounds a call's connect, send and reply; ``<= 0``
(the default) never times out, and an expired call raises
``socket.timeout``.
"""
from __future__ import annotations

import concurrent.futures
import datetime
import os
import pickle
import socket
import socketserver
import struct
import threading
import time
from dataclasses import dataclass

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos",
           "get_current_worker_info", "WorkerInfo", "FutureWrapper"]

#: the reference's default: -1, no timeout
_DEFAULT_RPC_TIMEOUT = -1
#: seconds the rendezvous and the shutdown barrier wait for every worker
_RENDEZVOUS_S = 120.0


def _dumps(obj) -> bytes:
    try:
        import cloudpickle
    except ImportError:
        return pickle.dumps(obj)
    return cloudpickle.dumps(obj)


class FutureWrapper:
    """What :func:`rpc_async` returns: ``wait()`` blocks and returns the
    result, raising the remote error."""

    def __init__(self, fut):
        self._fut = fut

    def wait(self, timeout=None):
        return self._fut.result(timeout)

    def result(self, timeout=None):
        return self._fut.result(timeout)

    def done(self):
        return self._fut.done()

    def __getattr__(self, name):
        return getattr(self._fut, name)


@dataclass
class WorkerInfo:
    name: str
    rank: int
    ip: str = "127.0.0.1"
    port: int = 0


_state = {"server": None, "pool": None, "workers": {}, "me": None,
          "store": None, "world": 1, "prefix": "", "inits": 0}


def _send_msg(sock, payload: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("rpc peer closed")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock) -> bytes:
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return _recv_exact(sock, n)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            payload = _recv_msg(self.request)
        except (ConnectionError, OSError):
            return
        try:
            fn, args, kwargs = pickle.loads(payload)
            result = ("ok", fn(*args, **(kwargs or {})))
        except Exception as e:          # the caller re-raises it
            result = ("err", e)
        try:
            try:
                reply = _dumps(result)
            except Exception as e:      # an unpicklable result or error
                reply = _dumps(("err", RuntimeError(
                    f"rpc result not serializable: {e!r}")))
            _send_msg(self.request, reply)
        except (ConnectionError, OSError):
            pass


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def _bind_host() -> str:
    ep = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
    return ep.rpartition(":")[0] if ":" in ep else "127.0.0.1"


def _store(rank: int, world: int, master_endpoint):
    """The rendezvous store and the key prefix of this ``init_rpc``."""
    import torch.distributed as dist
    ep = master_endpoint or os.environ.get("PADDLE_MASTER_ENDPOINT")
    n = _state["inits"]
    if ep:
        host, _, port = ep.rpartition(":")
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=datetime.timedelta(
                                  seconds=_RENDEZVOUS_S))
        return store, f"rpc{n}/"
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.distributed_c10d import _get_default_store
        return _get_default_store(), f"rpc{n}/"
    raise ValueError(f"init_rpc with world_size {world}: pass "
                     f"master_endpoint (host:port), set "
                     f"PADDLE_MASTER_ENDPOINT, or join a process group "
                     f"first")


def _wait_count(store, key: str, n: int, what: str) -> None:
    deadline = time.monotonic() + _RENDEZVOUS_S
    while store.add(key, 0) < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"rpc: {what}: {store.add(key, 0)} of {n} "
                               f"workers after {_RENDEZVOUS_S} s")
        time.sleep(0.02)


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """Start this worker's agent and meet the others (module docstring).
    ``rank`` and ``world_size`` default to the launcher's
    ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` (0 and 1 without
    them).  Returns this worker's :class:`WorkerInfo`."""
    if _state["server"] is not None:
        raise RuntimeError("init_rpc was called already; shutdown() first")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None \
        else int(rank)
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", 1)) \
        if world_size is None else int(world_size)
    host = _bind_host()
    server = _Server((host, 0), _Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    me = WorkerInfo(name, rank, host, server.server_address[1])
    _state.update(server=server, me=me, world=world,
                  pool=concurrent.futures.ThreadPoolExecutor(8))
    if world <= 1:
        _state["workers"] = {name: me}
        return me
    store, prefix = _store(rank, world, master_endpoint)
    _state["inits"] += 1
    _state.update(store=store, prefix=prefix)
    store.set(f"{prefix}worker/{rank}",
              pickle.dumps((name, rank, me.ip, me.port)))
    workers = {}
    for r in range(world):
        info = WorkerInfo(*pickle.loads(store.get(f"{prefix}worker/{r}")))
        workers[info.name] = info
    _state["workers"] = workers
    store.add(f"{prefix}ready", 1)
    _wait_count(store, f"{prefix}ready", world, "rendezvous")
    return me


def _target(to) -> WorkerInfo:
    w = _state["workers"].get(to)
    if w is None:
        raise ValueError(f"unknown rpc worker '{to}' "
                         f"(have {list(_state['workers'])})")
    return w


def _invoke(to, fn, args, kwargs, timeout):
    w = _target(to)
    me = _state["me"]
    if me is not None and w.name == me.name:
        return fn(*(args or ()), **(kwargs or {}))
    sock_timeout = None if timeout is None or timeout <= 0 else timeout
    with socket.create_connection((w.ip, w.port),
                                  timeout=sock_timeout) as s:
        s.settimeout(sock_timeout)
        _send_msg(s, _dumps((fn, args or (), kwargs or {})))
        status, value = pickle.loads(_recv_msg(s))
    if status == "err":
        raise value
    return value


def rpc_sync(to, fn, args=None, kwargs=None, timeout=_DEFAULT_RPC_TIMEOUT):
    """``fn(*args, **kwargs)`` on worker ``to``; blocks for the result
    (re-raising the remote error)."""
    return _invoke(to, fn, args, kwargs, timeout)


def rpc_async(to, fn, args=None, kwargs=None, timeout=_DEFAULT_RPC_TIMEOUT):
    """The same without blocking: a :class:`FutureWrapper`."""
    if _state["pool"] is None:
        raise RuntimeError("call init_rpc first")
    return FutureWrapper(
        _state["pool"].submit(_invoke, to, fn, args, kwargs, timeout))


def shutdown():
    """Wait for every worker to reach ``shutdown``, then stop this
    agent.  Rank 0, whose store the others may host on, returns last:
    once every worker has seen the others arrive."""
    store = _state["store"]
    if store is not None and _state["world"] > 1:
        prefix, world = _state["prefix"], _state["world"]
        store.add(f"{prefix}done", 1)
        _wait_count(store, f"{prefix}done", world, "shutdown")
        store.add(f"{prefix}left", 1)
        if _state["me"].rank == 0:
            _wait_count(store, f"{prefix}left", world, "shutdown")
    if _state["server"] is not None:
        _state["server"].shutdown()
        _state["server"].server_close()
    if _state["pool"] is not None:
        _state["pool"].shutdown(wait=False)
    _state.update(server=None, pool=None, store=None, workers={}, me=None,
                  world=1, prefix="")


def get_worker_info(name):
    return _target(name)


def get_all_worker_infos():
    return list(_state["workers"].values())


def get_current_worker_info():
    return _state["me"]
