"""A rendezvous of CPU processes (the counterpart of
``paddle_tpu/distributed/parallel_with_gloo.py``): for data-pipeline or
parameter-server processes that never touch a card.  Like the JAX
package's, it is a key-value store and its barriers, here
``torch.distributed.TCPStore`` on ``server_endpoint`` (rank 0 hosts it),
beside any process group of the training ranks."""
from __future__ import annotations

import datetime
import time

import torch.distributed as dist

__all__ = ["gloo_init_parallel_env", "gloo_barrier", "gloo_release"]

_GLOO: dict = {"store": None, "rank": 0, "world": 1, "round": 0}


def gloo_init_parallel_env(rank_id: int, rank_num: int, server_endpoint: str,
                           timeout: float = 120.0) -> None:
    """Join ``rank_num`` CPU processes at ``server_endpoint``
    (``"ip:port"``; rank 0 hosts the store), then wait for all of them."""
    gloo_release()
    if rank_num <= 1:
        return
    host, port = server_endpoint.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), rank_num, rank_id == 0,
                          timeout=datetime.timedelta(seconds=timeout))
    _GLOO.update(store=store, rank=rank_id, world=rank_num, round=0)
    gloo_barrier()


def gloo_barrier(timeout: float = 900.0) -> None:
    """Block until every rank reaches the same barrier round; raises
    ``TimeoutError`` after ``timeout`` seconds (a peer died)."""
    store, world = _GLOO["store"], _GLOO["world"]
    if store is None or world <= 1:
        return
    _GLOO["round"] += 1
    key = f"gloo/barrier/{_GLOO['round']}"
    store.add(key, 1)
    deadline = time.monotonic() + timeout
    delay = 0.001
    while store.add(key, 0) < world:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"gloo_barrier: only {store.add(key, 0)}/{world} ranks "
                f"arrived within {timeout}s; a peer likely died")
        time.sleep(delay)
        delay = min(delay * 2, 0.25)


def gloo_release() -> None:
    """Leave the rendezvous."""
    _GLOO.update(store=None, rank=0, world=1, round=0)
