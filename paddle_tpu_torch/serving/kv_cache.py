"""Paged KV cache: a block pool of fixed-size pages with free-list reuse.

The counterpart of ``paddle_tpu/serving/kv_cache.py``.  The pool owns
the device tensors the prefill and decode steps write in place
(``k_flat``/``v_flat``, shape ``(L, P*ps, H, D)``, plus f32 scale pools
``(L, P*ps, H)`` for an int8 pool), a host-side free list of page ids,
and a *reservation* ledger for admission control: the scheduler reserves
a sequence's worst-case page count (prompt + max_new_tokens) before
prefill, so an admitted sequence never stalls mid-decode for a page.

Page 0 is the **null page**: padding rows of a batch bucket and the
unused tail of every page table point at it, so padding lanes read and
write real (never read unmasked) storage.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..observability.metrics import get_registry
from ..observability.telemetry import get_telemetry

__all__ = ["PagePool", "KVPoolExhausted", "NULL_PAGE", "kv_page_budget"]

NULL_PAGE = 0


def kv_page_budget(pages: int, precision: str, head_dim: int) -> int:
    """Scale an fp32-denominated page budget to a precision's real cost.

    The configured page count is a byte budget in fp32 pages, so
    precisions compare at the same memory spend.  Per (token, head) an
    fp32 page row costs ``4*D`` bytes, bf16 ``2*D``, int8 ``D`` for the
    values plus 4 for the f32 scale.  The null page scales with the
    rest; the usable count gets the ratio.
    """
    if precision in ("fp32", "float32"):
        return pages
    fp32_cost = 4.0 * head_dim
    if precision in ("bf16", "bfloat16"):
        cost = 2.0 * head_dim
    elif precision == "int8":
        cost = head_dim + 4.0
    else:
        raise ValueError(f"unknown serve precision {precision!r}")
    return 1 + int((pages - 1) * fp32_cost / cost)


class KVPoolExhausted(RuntimeError):
    """Raised when an alloc/reserve exceeds pool headroom."""


class PagePool:
    """Block-pool allocator over the serve KV tensors.

    Thread safety: all bookkeeping is lock-guarded; the device tensors
    are written only from the engine's step loop.
    """

    def __init__(self, *, layers: int, pages: int, page_size: int,
                 heads: int, head_dim: int, dtype=torch.float32,
                 scale_pages: bool = False, device=None):
        if pages < 2:
            raise ValueError("pages must be >= 2 (page 0 is the null page)")
        self.layers = layers
        self.pages = pages
        self.page_size = page_size
        self.heads = heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.device = resolve_device(device)
        # an int8 pool carries per-(token, head) f32 scales in shadow
        # scale pools addressed by the same page table
        self.scale_pages = bool(scale_pages)
        shape = (layers, pages * page_size, heads, head_dim)
        self.k_flat = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_flat = torch.zeros(shape, dtype=dtype, device=self.device)
        sshape = (layers, pages * page_size, heads)
        self.k_scale = torch.zeros(sshape, device=self.device) \
            if self.scale_pages else None
        self.v_scale = torch.zeros(sshape, device=self.device) \
            if self.scale_pages else None
        self._lock = threading.Lock()
        # LIFO free list: hot pages get reused while still cache warm
        self._free: List[int] = list(range(pages - 1, 0, -1))
        self._reserved = 0
        self.stats = {
            "allocs": 0, "frees": 0, "alloc_failures": 0,
            "reserve_refusals": 0, "high_watermark": 0,
        }

    # -- capacity ----------------------------------------------------------

    @property
    def usable_pages(self) -> int:
        return self.pages - 1  # minus the null page

    def pages_needed(self, tokens: int) -> int:
        return max(1, -(-int(tokens) // self.page_size))

    def headroom(self) -> int:
        """Pages available to NEW admissions (free minus already promised)."""
        with self._lock:
            return len(self._free) - self._reserved

    # -- admission-control reservations ------------------------------------

    def can_admit(self, n_pages: int) -> bool:
        return self.headroom() >= n_pages

    def reserve(self, n_pages: int) -> None:
        """Promise ``n_pages`` to a sequence about to be admitted."""
        with self._lock:
            if len(self._free) - self._reserved < n_pages:
                self.stats["reserve_refusals"] += 1
                raise KVPoolExhausted(
                    f"reserve({n_pages}): only "
                    f"{len(self._free) - self._reserved} unreserved pages")
            self._reserved += n_pages
        self._gauges()

    def release_reservation(self, n_pages: int) -> None:
        """Return unused promised pages (sequence finished early)."""
        with self._lock:
            self._reserved = max(0, self._reserved - n_pages)
        self._gauges()

    # -- alloc / free -------------------------------------------------------

    def alloc(self, n_pages: int = 1, *, reserved: bool = False) -> List[int]:
        """Pop ``n_pages`` page ids off the free list.

        ``reserved=True`` draws down a prior :meth:`reserve` promise (the
        scheduler's path); an unreserved alloc can fail even when pages
        are free if they are all promised elsewhere.
        """
        with self._lock:
            avail = len(self._free) if reserved \
                else len(self._free) - self._reserved
            if avail < n_pages:
                self.stats["alloc_failures"] += 1
                raise KVPoolExhausted(
                    f"alloc({n_pages}): {avail} pages available")
            ids = [self._free.pop() for _ in range(n_pages)]
            if reserved:
                self._reserved = max(0, self._reserved - n_pages)
            self.stats["allocs"] += n_pages
            used = self.usable_pages - len(self._free)
            self.stats["high_watermark"] = max(
                self.stats["high_watermark"], used)
        self._gauges()
        return ids

    def free(self, page_ids: Sequence[int]) -> None:
        """Return a retired sequence's pages to the free list."""
        with self._lock:
            for pid in page_ids:
                if pid == NULL_PAGE:
                    raise ValueError("cannot free the null page")
                if not (0 < pid < self.pages):
                    raise ValueError(f"page id {pid} out of range")
                if pid in self._free:
                    raise ValueError(f"double free of page {pid}")
                self._free.append(pid)
            self.stats["frees"] += len(page_ids)
        self._gauges()

    def check_consistency(self, expect_all_free: bool = False) -> None:
        """Invariant check: no duplicate or lost pages.
        ``expect_all_free=True`` also requires a clean slate: every
        usable page free and no outstanding reservation."""
        with self._lock:
            assert len(set(self._free)) == len(self._free), "dup free ids"
            assert all(0 < p < self.pages for p in self._free)
            assert 0 <= self._reserved <= len(self._free), \
                f"reserved {self._reserved} > free {len(self._free)}"
            if expect_all_free:
                assert len(self._free) == self.usable_pages, \
                    (f"page leak: {self.usable_pages - len(self._free)} "
                     f"of {self.usable_pages} pages unaccounted for")
                assert self._reserved == 0, \
                    f"{self._reserved} pages still reserved"

    # -- device state -------------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            free = len(self._free)
            return {
                "pages": self.pages,
                "dtype": str(self.dtype).replace("torch.", ""),
                "scale_pages": self.scale_pages,
                "usable_pages": self.usable_pages,
                "free_pages": free,
                "used_pages": self.usable_pages - free,
                "reserved_pages": self._reserved,
                "utilization": (self.usable_pages - free) /
                max(1, self.usable_pages),
                **self.stats,
            }

    # -- metrics ------------------------------------------------------------

    def _gauges(self) -> None:
        """``pt_serve_kv_pages{state}`` and ``pt_serve_kv_utilization``;
        nothing while telemetry is off (the registry stays empty then)."""
        if not get_telemetry().enabled:
            return
        with self._lock:
            free = len(self._free)
            reserved = self._reserved
        g = get_registry().gauge(
            "pt_serve_kv_pages",
            "Serve KV page-pool occupancy by state",
            labelnames=("state",))
        g.set(self.usable_pages - free, state="used")
        g.set(free, state="free")
        g.set(reserved, state="reserved")
        get_registry().gauge(
            "pt_serve_kv_utilization",
            "Fraction of usable KV pages in use").set(
            (self.usable_pages - free) / max(1, self.usable_pages))

    def null_padded_table(self, page_ids: Sequence[int],
                          max_pages: int) -> np.ndarray:
        """Host-side page table row: ids then null-page padding."""
        if len(page_ids) > max_pages:
            raise ValueError(
                f"{len(page_ids)} pages exceed table width {max_pages}")
        row = np.full((max_pages,), NULL_PAGE, np.int32)
        row[:len(page_ids)] = np.asarray(page_ids, np.int32)
        return row
