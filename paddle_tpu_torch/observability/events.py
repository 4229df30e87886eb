"""JSONL event sink: an append-only stream of telemetry records (the
counterpart of ``paddle_tpu/observability/events.py``, with its record
fields and file names).

One file a process, so that processes never interleave half-lines;
rotated by size, renaming the current file to ``.1`` (one generation).
With a cluster identity (``run_id`` and ``process_index``) the file is
``<prefix>-<run_id>-<rank>.jsonl``, a name that survives a restart;
without one, ``<prefix>-<pid>.jsonl``.  Each record is one JSON object:

    {"ts": "2026-08-05T12:00:00.123+00:00", "pid": 4242,
     "run_id": "r7", "process_index": 1,
     "event": "step", "step": 17, "duration_sec": 0.0123, ...}

The directory and the file are made on the first :meth:`EventSink.emit`:
making a sink does no I/O.  A failed write never raises into the loop
it watches: it is counted in ``dropped`` and the file is reopened on the
next record.
"""
from __future__ import annotations

import json
import os
import re
import threading
from datetime import datetime, timezone

__all__ = ["EventSink"]

DEFAULT_MAX_BYTES = 32 << 20

# the run id goes into the file name: keep it safe there (records carry
# the raw value)
_UNSAFE = re.compile(r"[^A-Za-z0-9._-]")


class EventSink:
    def __init__(self, directory, prefix="telemetry",
                 max_bytes=DEFAULT_MAX_BYTES, run_id=None,
                 process_index=None):
        self.directory = directory
        self.prefix = prefix
        self.max_bytes = int(max_bytes)
        self.run_id = run_id
        self.process_index = (int(process_index)
                              if process_index is not None else None)
        self.dropped = 0
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0

    @property
    def path(self):
        if self.run_id is not None and self.process_index is not None:
            rid = _UNSAFE.sub("_", str(self.run_id))
            return os.path.join(
                self.directory,
                f"{self.prefix}-{rid}-{self.process_index}.jsonl")
        return os.path.join(self.directory,
                            f"{self.prefix}-{os.getpid()}.jsonl")

    def _open(self):
        os.makedirs(self.directory, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = self._fh.tell()

    def _rotate(self):
        self._fh.close()
        self._fh = None
        os.replace(self.path, self.path + ".1")
        self._open()

    def emit(self, event, **fields):
        """Append one record; True when it reached the file."""
        rec = {"ts": datetime.now(timezone.utc).isoformat(
                   timespec="milliseconds"),
               "pid": os.getpid(), "event": event}
        if self.run_id is not None:
            rec["run_id"] = self.run_id
        if self.process_index is not None:
            rec["process_index"] = self.process_index
        rec.update(fields)
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            try:
                if self._fh is None:
                    self._open()
                elif self._size + len(line) > self.max_bytes:
                    self._rotate()
                self._fh.write(line)
                self._fh.flush()
                self._size += len(line)
                return True
            except (OSError, ValueError):
                # ValueError: a write to a file closed under us (the
                # interpreter's shutdown, a fork closing descriptors)
                self.dropped += 1
                self._fh = None
                return False

    def close(self):
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
