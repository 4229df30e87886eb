"""Thread-safe, label-aware metrics registry (the counterpart of
``paddle_tpu/observability/metrics.py``; the same Prometheus text and
snapshots, byte for byte, for the same operations).

Three instruments, each optionally split by a fixed tuple of label
names: :class:`Counter` (monotone, ``inc``), :class:`Gauge` (``set`` /
``inc``) and :class:`Histogram` (fixed buckets, ``observe``).  A
registry renders every instrument as Prometheus exposition text 0.0.4
(:meth:`MetricsRegistry.prometheus_text`, what ``/metrics`` serves) or
as a JSON-able dict (:meth:`MetricsRegistry.snapshot`).

Making registries and instruments does no I/O, starts no thread and
touches no device: dicts behind one lock.  Asking for an existing
``(name, kind, labelnames)`` returns the same instrument; a conflicting
signature raises.
"""
from __future__ import annotations

import json
import math
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_registry", "log_buckets",
    "DEFAULT_TIME_BUCKETS",
]


def log_buckets(lo, hi, per_decade=3):
    """Log-spaced bucket upper bounds covering [lo, hi] inclusive."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    n = int(round(per_decade * math.log10(hi / lo)))
    out = [lo * (hi / lo) ** (i / n) for i in range(n + 1)]
    # short decimals keep the exposition text readable
    return [float(f"{b:.3g}") for b in out]


# 100 us .. 100 s, 3 buckets a decade: 19 bounds and +Inf
DEFAULT_TIME_BUCKETS = tuple(log_buckets(1e-4, 100.0, per_decade=3))

_INF = float("inf")


def _fmt(v):
    """A Prometheus sample value (integers without the ``.0``)."""
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s):
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s):
    return (str(s).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels_text(names, values, extra=()):
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs.extend(f'{n}="{_escape_label(v)}"' for n, v in extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    """One named instrument; its children keyed by label values."""

    kind = "untyped"

    def __init__(self, name, help, labelnames=(), lock=None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock if lock is not None else threading.Lock()
        self._children = {}

    def _key(self, labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _child(self, labels):
        key = self._key(labels)
        with self._lock:
            c = self._children.get(key)
            if c is None:
                c = self._children[key] = self._new_child()
            return c

    def _items(self):
        with self._lock:
            return sorted(self._children.items())


class _CounterValue:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterValue()

    def inc(self, amount=1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        c = self._child(labels)
        with self._lock:
            c.value += amount

    def value(self, **labels):
        return self._child(labels).value

    def expose(self, out, const=()):
        for key, c in self._items():
            out.append(f"{self.name}"
                       f"{_labels_text(self.labelnames, key, extra=const)} "
                       f"{_fmt(c.value)}")

    def snapshot_values(self):
        return {key: c.value for key, c in self._items()}


class Gauge(Counter):
    kind = "gauge"

    def inc(self, amount=1.0, **labels):
        c = self._child(labels)
        with self._lock:
            c.value += amount

    def dec(self, amount=1.0, **labels):
        self.inc(-amount, **labels)

    def set(self, value, **labels):
        c = self._child(labels)
        with self._lock:
            c.value = float(value)


class _HistogramValue:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets):
        self.counts = [0] * n_buckets  # a bucket's own count, not cumulative
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=None, lock=None):
        super().__init__(name, help, labelnames, lock=lock)
        bs = sorted(float(b) for b in (buckets or DEFAULT_TIME_BUCKETS))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        if bs[-1] != _INF:
            bs.append(_INF)
        self.buckets = tuple(bs)

    def _new_child(self):
        return _HistogramValue(len(self.buckets))

    def observe(self, value, **labels):
        c = self._child(labels)
        v = float(value)
        with self._lock:
            for i, b in enumerate(self.buckets):
                if v <= b:
                    c.counts[i] += 1
                    break
            c.sum += v
            c.count += 1

    def expose(self, out, const=()):
        for key, c in self._items():
            cum = 0
            for b, n in zip(self.buckets, c.counts):
                cum += n
                le = _labels_text(self.labelnames, key,
                                  extra=tuple(const) + (("le", _fmt(b)),))
                out.append(f"{self.name}_bucket{le} {cum}")
            lbl = _labels_text(self.labelnames, key, extra=const)
            out.append(f"{self.name}_sum{lbl} {_fmt(c.sum)}")
            out.append(f"{self.name}_count{lbl} {cum}")

    def snapshot_values(self):
        out = {}
        for key, c in self._items():
            cum, rows = 0, []
            for b, n in zip(self.buckets, c.counts):
                cum += n
                rows.append(["+Inf" if b == _INF else b, cum])
            out[key] = {"buckets": rows, "sum": c.sum, "count": c.count}
        return out

    def percentile(self, q, **labels):
        """Bucket-interpolated percentile (None while empty)."""
        c = self._child(labels)
        with self._lock:
            total = c.count
            if not total:
                return None
            target, cum, lo = q * total, 0, 0.0
            for b, n in zip(self.buckets, c.counts):
                if cum + n >= target and n:
                    if b == _INF:
                        return lo
                    frac = (target - cum) / n
                    return lo + (b - lo) * frac
                cum += n
                lo = b if b != _INF else lo
            return lo


class MetricsRegistry:
    """Named instruments behind one lock (every operation is a few
    dict reads and writes)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._const_labels: tuple = ()

    def set_const_labels(self, **labels):
        """Labels put on every exposed sample, after each metric's own and
        before a histogram's ``le``: this process's identity in a cluster
        scrape (``process_index``, ``run_id``), sorted by name."""
        with self._lock:
            self._const_labels = tuple(
                sorted((str(k), str(v)) for k, v in labels.items()))
        return self

    @property
    def const_labels(self):
        with self._lock:
            return dict(self._const_labels)

    def _get_or_make(self, cls, name, help, labelnames, **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def collect(self):
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def prometheus_text(self):
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            const = self._const_labels
        out = []
        for m in self.collect():
            out.append(f"# HELP {m.name} {_escape_help(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            m.expose(out, const=const)
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self):
        """Every instrument's state as a JSON-able dict."""
        out = {}
        for m in self.collect():
            series = {}
            for key, val in m.snapshot_values().items():
                lbl = ",".join(f"{n}={v}"
                               for n, v in zip(m.labelnames, key))
                series[lbl] = val
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "series": series}
        return out

    def snapshot_json(self, **json_kw):
        return json.dumps(self.snapshot(), **json_kw)


_registry = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process's registry (made on first use)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry


def reset_registry():
    """Drop the process's registry (test isolation)."""
    global _registry
    with _registry_lock:
        _registry = None
