"""Retry and backoff primitives of the port's distributed layer.

The counterpart of ``paddle_tpu/utils/retry.py`` (a copy: the port
imports nothing of the JAX package).  Every rendezvous or commit wait
in a preemptible fleet has the same failure mode: a fixed sleep with no
jitter and no deadline, so a mass restart retries in lockstep against
the same store or filesystem.  This module is the one way to wait:

 - :func:`backoff_delays` — the policy: exponential delays with
   symmetric jitter, capped per try and bounded by a total deadline.
 - :func:`retry_call`    — retry a callable on a filtered set of
   exceptions (store connects, store operations).
 - :func:`wait_until`    — poll a predicate until truthy (commit-marker
   waits, barrier seals), raising a descriptive TimeoutError.

Deterministic in tests: ``rng``, ``sleep`` and ``clock`` are injectable.
Standard library only.
"""
from __future__ import annotations

import random
import time

__all__ = ["backoff_delays", "retry_call", "wait_until"]


def backoff_delays(base=0.05, factor=2.0, max_delay=2.0, jitter=0.25,
                   deadline=None, max_tries=None, rng=None,
                   clock=time.monotonic):
    """Yield successive backoff delays (seconds); the caller sleeps.

    Delay i is ``min(max_delay, base * factor**i)`` scaled by a uniform
    jitter in ``[1-jitter, 1+jitter]``.  The generator stops (raising
    StopIteration to a ``next``, ending a ``for``) once ``max_tries``
    delays were yielded or the ``deadline`` (seconds from first call)
    would be exceeded; each yielded delay is clipped so the caller never
    sleeps past the deadline.
    """
    if base < 0 or factor < 1.0 or not (0.0 <= jitter <= 1.0):
        raise ValueError(f"invalid backoff policy: base={base} "
                         f"factor={factor} jitter={jitter}")
    rng = rng if rng is not None else random
    t0 = clock()
    i = 0
    while max_tries is None or i < max_tries:
        d = min(max_delay, base * factor ** i)
        if jitter:
            d *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
        if deadline is not None:
            remaining = deadline - (clock() - t0)
            if remaining <= 0:
                return
            d = min(d, remaining)
        yield d
        i += 1


def retry_call(fn, *args, retry_on=(Exception,), deadline=None,
               max_tries=None, base=0.05, factor=2.0, max_delay=2.0,
               jitter=0.25, on_retry=None, rng=None, sleep=time.sleep,
               clock=time.monotonic, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` exceptions
    with jittered exponential backoff.

    The first attempt always runs; afterwards the backoff budget
    (``deadline`` seconds total and/or ``max_tries`` retries) decides
    whether to sleep-and-retry or re-raise the last exception.
    ``on_retry(attempt, exc, delay)``, when given, observes each retry
    (log hook).  Exceptions outside ``retry_on`` propagate immediately.
    """
    delays = backoff_delays(base=base, factor=factor, max_delay=max_delay,
                            jitter=jitter, deadline=deadline,
                            max_tries=max_tries, rng=rng, clock=clock)
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            d = next(delays, None)
            if d is None:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, e, d)
            sleep(d)


def wait_until(pred, timeout=None, *, desc=None, diag=None, base=0.02,
               factor=1.5, max_delay=0.5, jitter=0.25, rng=None,
               sleep=time.sleep, clock=time.monotonic):
    """Poll ``pred()`` with jittered backoff until it returns a truthy
    value (returned), or ``timeout`` seconds elapse.

    On timeout raises :class:`TimeoutError` naming ``desc`` (or the
    predicate) — a wait that can hang forever with no diagnostic is how
    one dead rank silently wedges a whole job.  ``diag``, when given, is
    called once at timeout and its string return is appended to the
    error (e.g. which barrier ranks never arrived); a failing diag never
    masks the timeout itself.  ``timeout=None`` polls forever (the
    caller owns liveness, e.g. a supervising loop).
    """
    delays = backoff_delays(base=base, factor=factor, max_delay=max_delay,
                            jitter=jitter, deadline=timeout, rng=rng,
                            clock=clock)
    while True:
        value = pred()
        if value:
            return value
        d = next(delays, None)
        if d is None:
            what = desc or getattr(pred, "__name__", repr(pred))
            extra = ""
            if diag is not None:
                try:
                    extra = str(diag() or "")
                except Exception as e:  # diagnostics must not mask timeout
                    extra = f"(diagnostic probe failed: {e})"
            raise TimeoutError(
                f"wait_until: {what} still false after {timeout}s"
                + (f" — {extra}" if extra else ""))
        sleep(d)
