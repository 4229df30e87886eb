"""Continuous (in-flight) batching over the engine's bucketed steps.

The counterpart of ``paddle_tpu/serving/scheduler.py``; numpy and the
standard library only.  One scheduler tick = one *step boundary*:

 1. **evict** cancelled and deadline-expired sequences (free pages,
    release reservations, resolve the caller's stream with the error),
 2. **retire** sequences that finished last step,
 3. **admit** queued sequences while a decode slot AND worst-case KV
    headroom exist: admission reserves ``ceil((prompt+max_new)/ps)``
    pages up front, so an admitted sequence never stalls mid-decode
    waiting for a page,
 4. **decode** one token for every active row, padded to the smallest
    batch bucket.

Sequences join and leave a running batch only at these boundaries, and
the decode math is row independent (see :mod:`.model`), so a sequence's
tokens are bit-identical whether it decoded solo or inside a changing
batch of the same bucket.

Resilience:

 - every request may carry a **deadline** (client-supplied, or the
   server default ``ServeConfig.deadline_ms``); expired requests are
   evicted at the next step boundary and their pages returned,
 - :meth:`ContinuousScheduler.cancel` (``POST /v1/cancel``) evicts a
   request wherever it is, at a step boundary (decode holds the lock),
 - **load shedding**: admission refuses requests whose deadline is
   infeasible against measured decode throughput (EWMA of step wall
   time) and the backlog, and bounds the queue,
 - **graceful drain**: :meth:`drain_gracefully` stops admission,
   finishes in-flight decodes within a budget and cancels the rest
   (``cause="drain"``), the SIGTERM lifecycle of the HTTP front end,
 - **hang watchdog**: a sentinel thread compares the in-flight decode
   step's wall time with N x the rolling p99; a hung step degrades
   ``/healthz`` and, with ``PT_SERVE_WATCHDOG=exit``, fast-exits for a
   supervisor restart.
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..observability.metrics import get_registry
from ..observability.telemetry import get_telemetry
from .kv_cache import KVPoolExhausted

logger = logging.getLogger("paddle_tpu_torch.serving")

__all__ = ["ContinuousScheduler", "GenerationStream", "EngineSaturated",
           "RequestShed", "RequestCancelled", "DeadlineExceeded",
           "WATCHDOG_EXIT_CODE"]

# fast-exit status when PT_SERVE_WATCHDOG=exit trips: distinct from the
# drain exit (143) so a supervisor can tell "hung device" from "asked
# to stop" in the restart ledger
from ..distributed.exit_codes import EXIT_WATCHDOG as WATCHDOG_EXIT_CODE  # noqa: E402


class EngineSaturated(RuntimeError):
    """submit() refused: in-flight cap reached (caller should shed load
    or retry with backoff — the HTTP front end maps this to 429)."""


class RequestShed(EngineSaturated):
    """submit() refused by the load shedder.

    ``reason`` is one of ``deadline_infeasible`` (the request cannot
    finish before its deadline given measured throughput + backlog),
    ``queue_full`` (bounded queue at capacity even after evicting
    expired entries), or ``draining`` (SIGTERM lifecycle — admission is
    closed).  ``retry_after`` is the shedder's backlog estimate in
    seconds (the HTTP ``Retry-After`` header)."""

    def __init__(self, message: str, *, reason: str,
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after = retry_after


class RequestCancelled(RuntimeError):
    """The request was evicted before completing; ``cause`` is one of
    ``client`` | ``timeout`` | ``disconnect`` | ``drain``."""

    def __init__(self, message: str, *, cause: str = "client"):
        super().__init__(message)
        self.cause = cause


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it finished decoding; its
    pages were released at the next step boundary."""


class GenerationStream:
    """Future-like handle for one submitted request."""

    _ids = itertools.count()

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 deadline: Optional[float] = None):
        self.request_id = next(self._ids)
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.tokens: List[int] = []
        self.submitted_ts = time.monotonic()
        self.finished_ts: Optional[float] = None
        self.deadline = deadline        # absolute time.monotonic(), or None
        self.cancel_cause: Optional[str] = None
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._sched: Optional["ContinuousScheduler"] = None

    def cancel(self, cause: str = "client") -> bool:
        """Evict this request (queued or active) at the next step
        boundary, releasing its KV pages.  Returns whether the
        cancellation took effect (False once already finished)."""
        sched = self._sched
        if sched is not None:
            return sched.cancel(self.request_id, cause=cause)
        if not self._done.is_set():
            self.cancel_cause = cause
            self._finish(error=RequestCancelled(
                f"request {self.request_id} cancelled ({cause})",
                cause=cause))
            return True
        return False

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Wait for the final token list.

        A timeout CANCELS the request before raising — the abandoned
        caller must not keep decoding on borrowed KV pages (the page
        leak this layer exists to close)."""
        if not self._done.wait(timeout):
            self.cancel(cause="timeout")
            raise TimeoutError(
                f"request {self.request_id} not finished in {timeout}s")
        if self._error is not None:
            raise self._error
        return self.tokens

    @property
    def latency(self) -> Optional[float]:
        """Seconds from submit to the finish; None until finished."""
        if self.finished_ts is None:
            return None
        return self.finished_ts - self.submitted_ts

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self.finished_ts = time.monotonic()
        self._error = error
        self._done.set()


class _Active:
    """Per-sequence decode state while resident in the batch."""

    __slots__ = ("stream", "page_ids", "page_table", "pos", "last_token",
                 "reserved_left")

    def __init__(self, stream, page_ids, page_table, pos, last_token,
                 reserved_left):
        self.stream = stream
        self.page_ids = page_ids        # owned pages, in position order
        self.page_table = page_table    # np (max_pages,) int32
        self.pos = pos                  # position last_token will occupy
        self.last_token = last_token
        self.reserved_left = reserved_left


class ContinuousScheduler:
    """Admission + step loop; owns the queue and the active batch."""

    def __init__(self, engine):
        self.engine = engine
        self._queue: deque = deque()
        self._active: List[_Active] = []
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # resilience state ---------------------------------------------------
        self._draining = False
        self.hang_detected = False
        self._watchdog_thread: Optional[threading.Thread] = None
        self._step_started: Optional[float] = None  # in-flight decode t0
        self._step_times: deque = deque(maxlen=256)  # rolling wall times
        self._step_ewma: Optional[float] = None      # sec per decode step
        self.stats = {
            "submitted": 0, "completed": 0, "refused_inflight": 0,
            "refused_kv": 0, "steps": 0, "tokens_generated": 0,
            "occupancy_sum": 0.0, "occupancy_steps": 0,
            "peak_active": 0,
            "shed": 0, "cancelled": 0, "deadline_exceeded": 0,
            "failed": 0, "drain_seconds": None, "watchdog_trips": 0,
        }

    # -- submission ----------------------------------------------------------

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> GenerationStream:
        cfg = self.engine.config
        spec = self.engine.spec
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= spec.vocab_size for t in prompt):
            raise ValueError("prompt token out of vocab range")
        self.engine.prefill_bucket_for(len(prompt))  # raises if too long
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else cfg.max_new_tokens)
        max_new = max(1, min(max_new, spec.max_seq_len - len(prompt)))
        if deadline_ms is None:
            deadline_ms = getattr(cfg, "deadline_ms", 0.0)
        deadline_ms = float(deadline_ms or 0.0)
        if deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0")
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms > 0 else None)
        with self._cv:
            if self._draining:
                self._shed_locked("draining")
                raise RequestShed("engine draining — admission closed",
                                  reason="draining")
            inflight = len(self._queue) + len(self._active)
            if inflight >= cfg.max_inflight:
                self.stats["refused_inflight"] += 1
                self._book("pt_serve_admission_refusals_total",
                           kind="counter", reason="inflight_cap")
                raise EngineSaturated(
                    f"{inflight} requests in flight (cap "
                    f"{cfg.max_inflight})")
            max_queue = int(getattr(cfg, "max_queue", 0) or 0)
            if max_queue > 0 and len(self._queue) >= max_queue:
                # bounded queue: make room by evicting already-expired
                # entries (oldest first) before refusing fresh work
                self._expire_queue_locked()
                if len(self._queue) >= max_queue:
                    eta = self._backlog_eta_locked()
                    self._shed_locked("queue_full")
                    raise RequestShed(
                        f"queue full ({max_queue} waiting)",
                        reason="queue_full", retry_after=eta)
            if deadline is not None:
                eta = self._completion_eta_locked(max_new)
                if eta is not None and time.monotonic() + eta > deadline:
                    self._shed_locked("deadline_infeasible")
                    raise RequestShed(
                        f"deadline {deadline_ms:.0f}ms infeasible: "
                        f"estimated completion in {eta * 1e3:.0f}ms",
                        reason="deadline_infeasible",
                        retry_after=self._backlog_eta_locked())
            st = GenerationStream(prompt, max_new, deadline=deadline)
            st._sched = self
            self._queue.append(st)
            self.stats["submitted"] += 1
            self._book("pt_serve_requests_total", kind="counter")
            self._gauges_locked()
            self._cv.notify()
        return st

    def _shed_locked(self, reason: str) -> None:
        self.stats["shed"] += 1
        self._book("pt_serve_shed_total", kind="counter", reason=reason)

    def _completion_eta_locked(self, max_new: int) -> Optional[float]:
        """Seconds until a request submitted NOW would finish, from the
        measured step-time EWMA and the token backlog ahead of it.
        None until throughput has been measured (admit optimistically)."""
        ew = self._step_ewma
        if ew is None:
            return None
        return self._backlog_eta_locked() + ew * (max_new + 1)

    def _backlog_eta_locked(self) -> Optional[float]:
        ew = self._step_ewma
        if ew is None:
            return None
        backlog = sum(st.max_new_tokens for st in self._queue)
        backlog += sum(
            max(0, a.stream.max_new_tokens - len(a.stream.tokens))
            for a in self._active)
        max_batch = self.engine.config.decode_buckets[-1]
        return ew * (backlog / max(1, max_batch))

    # -- cancellation / eviction ---------------------------------------------

    def cancel(self, request_id: int, cause: str = "client") -> bool:
        """Evict a request wherever it is.  Taking the scheduler lock
        IS the step boundary — decode holds it — so an active row is
        removed between steps, never mid-kernel."""
        with self._cv:
            for st in self._queue:
                if st.request_id == request_id:
                    self._queue.remove(st)
                    self._finish_evicted_locked(st, cause)
                    self._gauges_locked()
                    return True
            for a in self._active:
                if a.stream.request_id == request_id:
                    self._active.remove(a)
                    self._release_locked(a)
                    self._finish_evicted_locked(a.stream, cause)
                    self._gauges_locked()
                    return True
        return False

    def _release_locked(self, a: _Active) -> None:
        pool = self.engine.pool
        pool.free(a.page_ids)
        if a.reserved_left:
            pool.release_reservation(a.reserved_left)

    def _finish_evicted_locked(self, st: GenerationStream,
                               cause: str) -> None:
        st.cancel_cause = cause
        if cause == "deadline":
            self.stats["deadline_exceeded"] += 1
            self._book("pt_serve_deadline_exceeded_total", kind="counter")
            err: BaseException = DeadlineExceeded(
                f"request {st.request_id} missed its deadline after "
                f"{len(st.tokens)}/{st.max_new_tokens} tokens")
        else:
            err = RequestCancelled(
                f"request {st.request_id} cancelled ({cause})",
                cause=cause)
        self.stats["cancelled"] += 1
        self._book("pt_serve_cancelled_total", kind="counter", cause=cause)
        st._finish(error=err)

    def _expire_queue_locked(self) -> None:
        now = time.monotonic()
        expired = [st for st in self._queue
                   if st.deadline is not None and now >= st.deadline]
        for st in expired:
            self._queue.remove(st)
            self._finish_evicted_locked(st, "deadline")

    def _evict_expired_locked(self) -> None:
        """Deadline sweep at the step boundary: queued AND active."""
        self._expire_queue_locked()
        now = time.monotonic()
        expired = [a for a in self._active
                   if a.stream.deadline is not None
                   and now >= a.stream.deadline]
        for a in expired:
            self._active.remove(a)
            self._release_locked(a)
            self._finish_evicted_locked(a.stream, "deadline")

    # -- the step loop -------------------------------------------------------

    def step(self) -> bool:
        """One step boundary: evict / retire / admit / decode.  Returns
        whether any work was done."""
        with self._lock:
            self._evict_expired_locked()
            # draining closes submit(), not the internal queue: every
            # request accepted before SIGTERM still owes a response
            self._admit_locked()
            worked = self._decode_locked()
            self.stats["steps"] += 1 if worked else 0
            self._gauges_locked()
            return worked or bool(self._queue)

    def _admit_locked(self) -> None:
        pool = self.engine.pool
        max_batch = self.engine.config.decode_buckets[-1]
        while self._queue and len(self._active) < max_batch:
            st = self._queue[0]
            worst_case = pool.pages_needed(len(st.prompt) + st.max_new_tokens)
            if not pool.can_admit(worst_case):
                # head-of-line blocking is deliberate: skipping ahead
                # would starve large requests under sustained load
                self.stats["refused_kv"] += 1
                self._book("pt_serve_admission_refusals_total",
                           kind="counter", reason="kv_headroom")
                break
            self._queue.popleft()
            try:
                pool.reserve(worst_case)
            except KVPoolExhausted:
                self.stats["refused_kv"] += 1
                self._queue.appendleft(st)
                break
            prompt_pages = pool.pages_needed(len(st.prompt))
            page_ids = pool.alloc(prompt_pages, reserved=True)
            reserved_left = worst_case - prompt_pages
            page_table = pool.null_padded_table(
                page_ids, self.engine.max_pages_per_seq)
            try:
                first = self.engine.prefill(st.prompt, page_table)
            except Exception as exc:  # resolve the caller, keep serving
                pool.free(page_ids)
                pool.release_reservation(reserved_left)
                self.stats["failed"] += 1
                self._book("pt_serve_request_failures_total",
                           kind="counter", stage="prefill")
                st._finish(error=exc)
                logger.exception("prefill failed for request %d",
                                 st.request_id)
                continue
            st.tokens.append(first)
            self._book("pt_serve_tokens_total", kind="counter")
            self.stats["tokens_generated"] += 1
            act = _Active(st, page_ids, page_table, pos=len(st.prompt),
                          last_token=first, reserved_left=reserved_left)
            if self._is_finished(act):
                self._retire_locked(act)
            else:
                self._active.append(act)
                self.stats["peak_active"] = max(
                    self.stats["peak_active"], len(self._active))

    def _decode_locked(self) -> bool:
        if not self._active:
            return False
        pool = self.engine.pool
        ps = self.engine.config.page_size
        # grow page tables for rows whose next write crosses a page
        # boundary — drawn from the admission-time reservation, so this
        # alloc cannot fail
        for a in self._active:
            need = a.pos // ps + 1
            if need > len(a.page_ids):
                new = pool.alloc(need - len(a.page_ids), reserved=True)
                for pid in new:
                    a.page_table[len(a.page_ids)] = pid
                    a.page_ids.append(pid)
                a.reserved_left -= len(new)
        n = len(self._active)
        tokens = np.asarray([a.last_token for a in self._active], np.int32)
        positions = np.asarray([a.pos for a in self._active], np.int32)
        tables = np.stack([a.page_table for a in self._active])
        t0 = time.monotonic()
        self._step_started = t0  # watchdog arms on the device call
        try:
            nxt = self.engine.decode(tokens, positions, tables)
        except Exception as exc:
            # a failed device step fails every resident request — with
            # their pages RETURNED — and the loop keeps serving the
            # queue; one poisoned batch must not wedge the engine
            self._step_started = None
            self._fail_batch_locked(exc)
            return True
        finally:
            self._step_started = None
        dt = time.monotonic() - t0
        self._step_times.append(dt)
        self._step_ewma = (dt if self._step_ewma is None
                           else 0.2 * dt + 0.8 * self._step_ewma)
        bucket = self.engine.decode_bucket_for(n)
        self.stats["occupancy_sum"] += n / bucket
        self.stats["occupancy_steps"] += 1
        self._book("pt_serve_batch_occupancy", kind="gauge",
                   value=n / bucket)
        still = []
        for a, t in zip(self._active, nxt):
            try:
                a.pos += 1
                a.last_token = int(t)
                a.stream.tokens.append(int(t))
                self.stats["tokens_generated"] += 1
                self._book("pt_serve_tokens_total", kind="counter")
                if self._is_finished(a):
                    self._retire_locked(a)
                else:
                    still.append(a)
            except Exception as exc:
                # per-row isolation: this request fails alone; its
                # neighbours keep decoding and its pages come back
                self._release_locked(a)
                self.stats["failed"] += 1
                self._book("pt_serve_request_failures_total",
                           kind="counter", stage="step")
                a.stream._finish(error=exc)
                logger.exception("step bookkeeping failed for request %d",
                                 a.stream.request_id)
        self._active = still
        return True

    def _fail_batch_locked(self, exc: BaseException) -> None:
        for a in self._active:
            self._release_locked(a)
            self.stats["failed"] += 1
            self._book("pt_serve_request_failures_total",
                       kind="counter", stage="decode")
            a.stream._finish(error=exc)
        logger.exception("decode step failed; %d requests failed, pages "
                         "released", len(self._active))
        self._active = []

    def _is_finished(self, a: _Active) -> bool:
        st = a.stream
        if len(st.tokens) >= st.max_new_tokens:
            return True
        eos = self.engine.config.eos_id
        return eos >= 0 and a.last_token == eos

    def _retire_locked(self, a: _Active) -> None:
        pool = self.engine.pool
        pool.free(a.page_ids)
        if a.reserved_left:
            pool.release_reservation(a.reserved_left)
        a.stream._finish()
        self.stats["completed"] += 1
        lat = a.stream.latency
        self._book("pt_serve_request_latency_seconds", kind="histogram",
                   value=lat)
        self._book("pt_serve_completed_total", kind="counter")

    # -- loop management -----------------------------------------------------

    def start(self) -> None:
        """Run the step loop on a background thread (HTTP-serving mode).
        Also arms the hang watchdog when ``PT_SERVE_WATCHDOG`` asks for
        it."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="pt-serve-scheduler", daemon=True)
            self._thread.start()
        self._start_watchdog()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        w = self._watchdog_thread
        if w is not None:
            w.join(timeout)
            self._watchdog_thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                while (not self._queue and not self._active
                       and not self._stop.is_set()):
                    self._cv.wait(0.05)
            if self._stop.is_set():
                return
            try:
                self.step()
            except Exception:
                logger.exception("scheduler step failed")
                time.sleep(0.01)

    def drain(self) -> None:
        """Block until queue and batch are empty.  Steps inline when no
        background loop is running (synchronous/generate mode)."""
        if self._thread is not None and self._thread.is_alive():
            while True:
                with self._lock:
                    if not self._queue and not self._active:
                        return
                time.sleep(0.002)
        while True:
            with self._lock:
                if not self._queue and not self._active:
                    return
            self.step()

    # -- graceful drain (SIGTERM lifecycle) ----------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Close admission: every subsequent submit sheds with
        ``reason="draining"`` and ``/healthz`` degrades so load
        balancers stop routing here."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()

    def drain_gracefully(self, budget_s: Optional[float] = None) -> bool:
        """Stop admission, finish in-flight work within ``budget_s``
        (default ``ServeConfig.drain_s``), then cancel whatever is left
        with ``cause="drain"``.  Returns True when everything finished
        inside the budget (no request was cut short)."""
        t0 = time.monotonic()
        self.begin_drain()
        if budget_s is None:
            budget_s = float(getattr(self.engine.config, "drain_s", 10.0))
        loop_running = (self._thread is not None
                        and self._thread.is_alive())
        while time.monotonic() - t0 < budget_s:
            with self._lock:
                if not self._queue and not self._active:
                    break
            if loop_running:
                time.sleep(0.01)
            else:
                self.step()
        clean = True
        with self._cv:
            leftovers = list(self._queue)
            self._queue.clear()
            for st in leftovers:
                clean = False
                self._finish_evicted_locked(st, "drain")
            for a in list(self._active):
                clean = False
                self._active.remove(a)
                self._release_locked(a)
                self._finish_evicted_locked(a.stream, "drain")
            self._gauges_locked()
        dur = time.monotonic() - t0
        self.stats["drain_seconds"] = dur
        self._book("pt_serve_drain_seconds", kind="gauge", value=dur)
        logger.info("graceful drain %s in %.3fs",
                    "completed" if clean else
                    "cut short (budget exhausted)", dur)
        return clean

    # -- hang watchdog --------------------------------------------------------

    @staticmethod
    def _watchdog_mode() -> Optional[str]:
        mode = os.environ.get("PT_SERVE_WATCHDOG", "").strip().lower()
        if mode in ("", "0", "off", "false", "no"):
            return None
        return "exit" if mode == "exit" else "on"

    def _start_watchdog(self) -> None:
        mode = self._watchdog_mode()
        if mode is None:
            return
        if (self._watchdog_thread is not None
                and self._watchdog_thread.is_alive()):
            return
        factor = float(os.environ.get("PT_SERVE_WATCHDOG_FACTOR", "20"))
        floor = float(os.environ.get("PT_SERVE_WATCHDOG_FLOOR_S", "1.0"))
        self._watchdog_thread = threading.Thread(
            target=self._watchdog_loop, args=(mode, factor, floor),
            name="pt-serve-watchdog", daemon=True)
        self._watchdog_thread.start()

    def _watchdog_loop(self, mode: str, factor: float,
                       floor: float) -> None:
        poll = max(0.02, min(0.25, floor / 4))
        while not self._stop.wait(poll):
            started = self._step_started
            if started is None:
                continue
            times = list(self._step_times)
            p99 = float(np.percentile(times, 99)) if times else None
            threshold = max(floor, factor * p99) if p99 else floor
            stuck = time.monotonic() - started
            if stuck > threshold:
                self._trip_watchdog(mode, stuck, threshold)
                return

    def _trip_watchdog(self, mode: str, stuck: float,
                       threshold: float) -> None:
        """The in-flight decode step is hung (NOT merely loaded: the
        threshold tracks the rolling p99).  Runs WITHOUT the scheduler
        lock — the hung step is holding it."""
        self.hang_detected = True
        self.stats["watchdog_trips"] += 1
        try:
            rids = [a.stream.request_id for a in list(self._active)]
        except Exception:
            rids = []
        logger.error(
            "serve hang watchdog tripped: decode step in flight for "
            "%.3fs (threshold %.3fs); active batch %s",
            stuck, threshold, rids)
        self._book("pt_serve_hang_watchdog_trips_total", kind="counter")
        if mode == "exit":
            logger.error("PT_SERVE_WATCHDOG=exit: fast-exiting %d for "
                         "supervisor restart", WATCHDOG_EXIT_CODE)
            os._exit(WATCHDOG_EXIT_CODE)

    # -- health ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            occ = (self.stats["occupancy_sum"] /
                   max(1, self.stats["occupancy_steps"]))
            return {
                "queue_depth": len(self._queue),
                "active_sequences": len(self._active),
                "batch_occupancy_mean": occ,
                "draining": self._draining,
                "hang_detected": self.hang_detected,
                "decode_step_ewma_s": self._step_ewma,
                **{k: v for k, v in self.stats.items()
                   if k not in ("occupancy_sum",)},
            }

    # -- metrics -------------------------------------------------------------

    def _gauges_locked(self) -> None:
        self._book("pt_serve_queue_depth", kind="gauge",
                   value=len(self._queue))
        self._book("pt_serve_active_sequences", kind="gauge",
                   value=len(self._active))

    def _book(self, name: str, *, kind: str, value: float = 1.0,
              **labels) -> None:
        """One sample of the serve series ``name``; nothing while
        telemetry is off (the registry stays empty then)."""
        if not get_telemetry().enabled:
            return
        reg = get_registry()
        help_ = _METRIC_HELP.get(name, "")
        if kind == "counter":
            reg.counter(name, help_,
                        labelnames=tuple(labels)).inc(value, **labels)
        elif kind == "gauge":
            reg.gauge(name, help_,
                      labelnames=tuple(labels)).set(value, **labels)
        else:
            reg.histogram(name, help_,
                          labelnames=tuple(labels)).observe(value, **labels)


_METRIC_HELP = {
    "pt_serve_requests_total": "Requests accepted by the serve scheduler",
    "pt_serve_completed_total": "Requests completed",
    "pt_serve_admission_refusals_total":
        "Admissions refused, by reason (inflight_cap|kv_headroom)",
    "pt_serve_shed_total":
        "Requests shed at admission, by reason "
        "(deadline_infeasible|queue_full|draining)",
    "pt_serve_cancelled_total":
        "Requests evicted before completing, by cause "
        "(client|timeout|deadline|disconnect|drain)",
    "pt_serve_deadline_exceeded_total":
        "Requests that missed their deadline (shed or evicted)",
    "pt_serve_drain_seconds":
        "Wall time of the last graceful drain",
    "pt_serve_request_failures_total":
        "Requests failed by an exception in the step loop, by stage "
        "(prefill|decode|step)",
    "pt_serve_hang_watchdog_trips_total":
        "Hang-watchdog trips (decode step exceeded Nx rolling p99)",
    "pt_serve_tokens_total": "Tokens generated by the serve engine",
    "pt_serve_queue_depth": "Requests waiting for admission",
    "pt_serve_active_sequences": "Sequences resident in the decode batch",
    "pt_serve_batch_occupancy":
        "Active rows / decode bucket size of the last step",
    "pt_serve_request_latency_seconds":
        "End-to-end request latency (submit to last token)",
}
