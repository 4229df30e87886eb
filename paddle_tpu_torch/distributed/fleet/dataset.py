"""File-streaming datasets of parameter-server training (the counterpart
of ``paddle_tpu/distributed/fleet/dataset.py``; the reference's
``fleet/dataset/dataset.py`` ``DatasetBase``, ``InMemoryDataset`` and
``QueueDataset`` over its C++ MultiSlot data feeds).

Files stream through ``pipe_command`` as a real subprocess (the command
reads a file's bytes on stdin and writes MultiSlot text), each line
parses into one numpy array a slot on the host, and the dataset yields
dict batches of numpy arrays.  The MultiSlot line is the reference's:
for each slot, in ``use_var`` order, ``<n> v1 ... vn``.  A malformed
line, a slot that breaks its declared static size, or a pipe command
that exits non-zero raises.
"""
from __future__ import annotations

import random
import subprocess

import numpy as np

__all__ = ["DatasetBase", "InMemoryDataset", "QueueDataset"]


class DatasetBase:
    """``init(**kwargs)`` takes the reference's keys: batch_size,
    thread_num, use_var (names, or objects with ``name``, ``dtype`` and
    ``shape``), pipe_command, input_type, fs_name, fs_ugi,
    download_cmd."""

    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.use_var = []
        self.pipe_command = "cat"
        self.input_type = 0
        self.fs_name = ""
        self.fs_ugi = ""
        self.download_cmd = "cat"
        self.filelist = []

    def init(self, batch_size=1, thread_num=1, use_var=None,
             pipe_command="cat", input_type=0, fs_name="", fs_ugi="",
             download_cmd="cat", **kwargs):
        self.batch_size = int(batch_size)
        self.thread_num = int(thread_num)
        self.use_var = list(use_var or [])
        self.pipe_command = pipe_command
        self.input_type = input_type
        self.fs_name = fs_name
        self.fs_ugi = fs_ugi
        self.download_cmd = download_cmd
        return self

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    # -- slots --------------------------------------------------------------
    def _slot_meta(self):
        """(name, numpy dtype, static size) a slot.  A slot stacks into a
        (B, n) array exactly when its ``use_var`` declares a static size
        (a positive last dimension of its ``shape``); otherwise its batch
        is always a list of arrays, whatever the lengths."""
        meta = []
        for v in self.use_var:
            name = getattr(v, "name", v)
            dt = str(getattr(v, "dtype", "float32"))
            np_dt = np.int64 if "int" in dt else np.float32
            fixed = None
            shape = getattr(v, "shape", None)
            if shape:
                last = shape[-1]
                if isinstance(last, int) and last > 0:
                    fixed = last
            meta.append((str(name), np_dt, fixed))
        return meta

    def _parse_line(self, line, meta):
        toks = line.split()
        rec, i = [], 0
        for name, dt, fixed in meta:
            if i >= len(toks):
                raise ValueError(
                    f"MultiSlot parse error: line ended before slot "
                    f"'{name}' ({line[:80]!r})")
            n = int(toks[i])
            vals = np.asarray(toks[i + 1:i + 1 + n], dtype=dt)
            if len(vals) != n:
                raise ValueError(
                    f"MultiSlot parse error: slot '{name}' declared {n} "
                    f"values, found {len(vals)}")
            if fixed is not None and n != fixed:
                raise ValueError(
                    f"MultiSlot parse error: slot '{name}' declares a "
                    f"static size {fixed} but a record carries {n} values")
            i += 1 + n
            rec.append(vals)
        if i != len(toks):
            raise ValueError(
                f"MultiSlot parse error: {len(toks) - i} trailing tokens "
                f"after the {len(meta)} declared slots: use_var is "
                f"missing a slot or lists slots in the wrong order")
        return rec

    def _stream_records(self):
        meta = self._slot_meta()
        for path in self.filelist:
            with open(path, "rb") as f:
                proc = subprocess.Popen(
                    self.pipe_command, shell=True, stdin=f,
                    stdout=subprocess.PIPE)
                try:
                    for raw in proc.stdout:
                        line = raw.decode().strip()
                        if line:
                            yield self._parse_line(line, meta)
                finally:
                    proc.stdout.close()
                    try:
                        rc = proc.wait(timeout=600.0)
                    except subprocess.TimeoutExpired:
                        # a command that ignores its closed stdout
                        proc.kill()
                        rc = proc.wait(timeout=10.0)
                # a failed command must not leave a truncated stream
                if rc != 0:
                    raise RuntimeError(
                        f"pipe_command {self.pipe_command!r} exited with "
                        f"status {rc} on {path!r}")

    def _batches(self, records):
        meta = self._slot_meta()
        buf = []
        for rec in records:
            buf.append(rec)
            if len(buf) == self.batch_size:
                yield self._pack(buf, meta)
                buf = []
        if buf:
            yield self._pack(buf, meta)

    @staticmethod
    def _pack(buf, meta):
        out = {}
        for j, (name, _, fixed) in enumerate(meta):
            cols = [r[j] for r in buf]
            out[name] = np.stack(cols) if fixed is not None else cols
        return out

    def get_filelist(self):
        return list(self.filelist)


class QueueDataset(DatasetBase):
    """Files -> pipe_command -> batches, one pass, nothing kept."""

    def __iter__(self):
        return self._batches(self._stream_records())


class InMemoryDataset(DatasetBase):
    """Load every record, then shuffle and iterate."""

    def __init__(self):
        super().__init__()
        self._memory = None
        self._distributed_settings = {}

    def _init_distributed_settings(self, **kwargs):
        """The reference's transport settings (merge_size, parse_ins_id,
        fleet_send_*), kept and not read: iteration is on this host."""
        self._distributed_settings.update(kwargs)

    def update_settings(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self._distributed_settings[k] = v

    def load_into_memory(self, is_shuffle=False):
        self._memory = list(self._stream_records())
        if is_shuffle:
            self.local_shuffle()

    def local_shuffle(self):
        """Shuffle the records with the ``random`` module (one
        ``random.seed`` gives the JAX package's order)."""
        if self._memory is None:
            raise RuntimeError("call load_into_memory() first")
        random.shuffle(self._memory)

    def global_shuffle(self, fleet=None, thread_num=12):
        """On one host the global shuffle is the local one (the
        reference redistributes records among its trainers)."""
        self.local_shuffle()

    def release_memory(self):
        self._memory = None

    def get_memory_data_size(self, fleet=None):
        return len(self._memory) if self._memory is not None else 0

    def get_shuffle_data_size(self, fleet=None):
        return self.get_memory_data_size(fleet)

    def __iter__(self):
        if self._memory is None:
            raise RuntimeError("call load_into_memory() first")
        return self._batches(iter(self._memory))
