"""The trial recorder (the counterpart of
``paddle_tpu/distributed/auto_tuner/recorder.py``; the reference's
``History_recorder``).  Its CSV is the JAX package's, byte for byte."""
from __future__ import annotations

import csv
import json
import os

__all__ = ["HistoryRecorder"]


class HistoryRecorder:
    def __init__(self, metric="throughput", maximize=True):
        self.history = []
        self.metric = metric
        self.maximize = maximize

    def add_cfg(self, **cfg):
        self.history.append(dict(cfg))

    def sort_metric(self):
        def key(c):
            v = c.get(self.metric)
            if not isinstance(v, (int, float)):  # None, or '' from a CSV
                return float("-inf") if self.maximize else float("inf")
            return v
        self.history.sort(key=key, reverse=self.maximize)

    def get_best(self):
        """(the best trial with status ok and a numeric metric, False),
        or (None, True) when there is none."""
        self.sort_metric()
        ok = [c for c in self.history
              if c.get("status", "ok") == "ok" and
              isinstance(c.get(self.metric), (int, float))]
        if not ok:
            return None, True
        return ok[0], False

    def store_history(self, path="./history.csv"):
        if not self.history:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        keys = sorted({k for c in self.history for k in c})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            for c in self.history:
                w.writerow(c)

    def load_history(self, path="./history.csv"):
        """(rows, False) from ``path``, each value read back as JSON where
        it parses (an empty cell as None); ([], True) without a file."""
        if not os.path.exists(path):
            return [], True
        with open(path) as f:
            rows = list(csv.DictReader(f))
        for r in rows:
            for k, v in list(r.items()):
                if v == "":
                    r[k] = None
                    continue
                try:
                    r[k] = json.loads(v)
                except ValueError:
                    pass  # not JSON: the CSV's string is the value
        self.history = rows
        return rows, False
