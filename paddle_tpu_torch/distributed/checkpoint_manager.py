"""CheckpointManager: step-numbered, crash-consistent checkpoint rotation.

The counterpart of ``paddle_tpu/distributed/checkpoint_manager.py``, on
the same directory layout (``<root>/step_<n:08d>``).  The resume loop:

    mgr = CheckpointManager(root, keep_last_n=3)
    state, step = mgr.restore_latest(template=state)   # relaunch path
    for i in range(step or 0, total_steps):
        loss = train_step(...)
        mgr.save(i + 1, state)                         # atomic commit

(:func:`paddle_tpu_torch.train.save_checkpoint` and
:func:`~paddle_tpu_torch.train.restore_checkpoint` do this for a
``TrainStep``, copying into its live tensors.)  Each ``save`` lands in
``<root>/step_<n>`` through the atomic-commit protocol of
:mod:`.checkpoint`, so a crash at any instant leaves the previous
committed checkpoint or the new one, never a half-written directory.
``restore_latest`` walks steps newest first, skipping uncommitted or
corrupt directories, and keep-last-N garbage collection never deletes
the only valid checkpoint.

Several processes (one a rank of a sharded step) save and restore
together: each writes its windows into the same step directory, and,
unless a ``store`` is given, they meet over the default process group's
``torch.distributed`` store (:class:`.checkpoint.ProcessGroupStore`);
every rank restores the same step.

Async mode (``async_save=True``): the device-to-host copy of every
tensor is taken on the caller and is complete when ``save`` returns (a
captured step overwrites its parameters and moments at the next replay);
serialization, fsync and commit run on one background writer thread.
A write failure is raised by the next manager call.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import re
import shutil
import threading
import time
import zlib

import torch

from ..observability.telemetry import get_telemetry
from . import checkpoint as _ckpt
from .checkpoint import CheckpointCorruptError

__all__ = ["CheckpointManager", "latest_checkpoint"]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^step_(\d+)\.(tmp|old)\.")


def _step_dirname(step):
    return f"step_{int(step):08d}"


class CheckpointManager:
    """Rotating step-numbered checkpoints with resume-from-latest.

    Args:
        root: directory holding ``step_<n>`` checkpoint subdirectories.
        keep_last_n: committed checkpoints to retain (None = keep all).
        async_save: commit on a background writer thread (module doc).
        store / world_size / process_index: multi-process commit
            plumbing, passed to :func:`.checkpoint.save_sharded`.
        integrity: verification level of restores: "full" (CRC32 and
            content digests), "size", or "off" (markers only).
        durable: fsync every write (disable only in tests).
        run_id: isolates multi-process barrier keys across relaunches of
            the same job (default ``$PT_RUN_ID``).
        barrier_timeout: seconds each process waits at the commit
            barrier before the timeout names the missing ranks.
        elastic: accept checkpoints written at another world size
            (including partial marker sets), re-sharding from the
            committed ranks' windows; a leaf with a hole makes that step
            invalid and restore falls back.
        orphan_age: at construction, sweep staging and partial-commit
            debris older than this many seconds from ``root``
            (:func:`.checkpoint.sweep_staging`); None disables it.
    """

    def __init__(self, root, keep_last_n=3, async_save=False, store=None,
                 world_size=None, process_index=None, integrity="full",
                 durable=True, run_id=None, barrier_timeout=300.0,
                 elastic=False, orphan_age=3600.0):
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
        self.root = root
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self.store = store
        self.world_size = world_size
        self.process_index = process_index
        self.integrity = integrity
        self.durable = durable
        self.run_id = run_id if run_id is not None \
            else os.environ.get("PT_RUN_ID")
        self.barrier_timeout = barrier_timeout
        self.elastic = elastic
        os.makedirs(root, exist_ok=True)
        if orphan_age is not None:
            _ckpt.sweep_staging(root, max_age=orphan_age)
        self._bad: set = set()          # steps that failed a full verify
        self._err = None
        self._lock = threading.Lock()
        self._inflight = None

    # -- enumeration --------------------------------------------------------
    def _step_dirs(self):
        out = {}
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return out
        for n in names:
            m = _STEP_RE.match(n)
            if m:
                out[int(m.group(1))] = os.path.join(self.root, n)
        return out

    def step_dir(self, step):
        return os.path.join(self.root, _step_dirname(step))

    def all_steps(self):
        """Every step directory present, committed or not, ascending."""
        return sorted(self._step_dirs())

    def valid_steps(self):
        """Steps whose directory is committed and passes the cheap
        size-level manifest scan, minus any step a restore proved
        corrupt, ascending."""
        out = []
        for step, d in sorted(self._step_dirs().items()):
            if step in self._bad:
                continue
            try:
                _ckpt.verify_checkpoint(d, integrity="size",
                                        elastic=self.elastic)
            except (CheckpointCorruptError, FileNotFoundError,
                    ValueError) as e:
                logger.debug("checkpoint %s not valid: %s", d, e)
                continue
            out.append(step)
        return out

    def latest_step(self):
        """Newest valid step, or None."""
        steps = self.valid_steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------
    def _raise_pending(self):
        with self._lock:
            err, self._err = self._err, None
        if err is not None:
            raise err

    def _rank_world(self):
        proc = (_ckpt.process_index() if self.process_index is None
                else self.process_index)
        world = (_ckpt.world_size() if self.world_size is None
                 else self.world_size)
        return proc, world

    @staticmethod
    def _data_state_records(proc, data_state):
        """The input pipeline's cursor (or any JSON-able state, such as a
        learning-rate schedule's) as a per-process JSON record: it rides
        the same atomic commit as the tensors."""
        if data_state is None:
            return ()
        blob = json.dumps(data_state, sort_keys=True).encode("utf-8")
        return ((f"data_state.{proc}.json", blob),)

    def _commit(self, records, path, proc, world, step, mode):
        """Write and commit, book the save (``mode``: sync or async; an
        async failure is booked by the caller), then the retention GC."""
        tel = get_telemetry()
        t0 = time.perf_counter()
        try:
            _ckpt._save_records(records, path, proc, world,
                                store=self._coordination_store(world),
                                durable=self.durable, run_id=self._tag(),
                                barrier_timeout=self.barrier_timeout)
        except BaseException:
            if mode == "sync":
                tel.record_checkpoint_save(time.perf_counter() - t0,
                                           step=step, mode=mode, ok=False)
            raise
        tel.record_checkpoint_save(time.perf_counter() - t0, step=step,
                                   mode=mode)
        self._gc()

    def save(self, step, state, block=False, data_state=None):
        """Commit ``state`` (a nested dict of tensors) as step ``step``.

        Sync mode writes and commits before returning.  Async mode takes
        a host copy of every tensor now (complete when this returns),
        queues the write and returns; a failure of the background commit
        is raised by the next ``save()`` or ``wait()``.  ``block=True``
        commits synchronously even in async mode.  ``data_state`` (a
        JSON-able dict) is committed beside the tensors and read back by
        :meth:`load_data_state`."""
        self._raise_pending()
        proc, world = self._rank_world()
        path = self.step_dir(step)
        extra = self._data_state_records(proc, data_state)
        if not self.async_save or block:
            self.wait()
            self._commit(itertools.chain(
                extra, _ckpt._shard_records(state, proc)), path, proc, world,
                step, "sync")
            return
        snapshot = _ckpt._snapshot(state)
        self.wait()  # one writer at a time, in step order

        def _write():
            try:
                self._commit(itertools.chain(
                    extra, _ckpt._shard_records(snapshot, proc)),
                    path, proc, world, step, "async")
            except BaseException as e:  # raised by the next call
                get_telemetry().record_async_save_failure(step, e)
                with self._lock:
                    self._err = e

        t = threading.Thread(target=_write, daemon=True,
                             name=f"ckpt-save-{step}")
        self._inflight = t
        t.start()

    def wait(self):
        """Drain any in-flight async save; re-raises its failure."""
        t, self._inflight = self._inflight, None
        while t is not None and t.is_alive():
            t.join(timeout=60.0)
            if t.is_alive():
                logger.warning("async save %s still writing after 60s; "
                               "waiting", t.name)
        self._raise_pending()

    # -- restore ------------------------------------------------------------
    def restore_latest(self, template=None, mesh=None, shardings=None, *,
                       device=None):
        """Load the newest valid checkpoint, falling back past
        uncommitted or corrupt directories to the newest one that
        verifies clean (:func:`.checkpoint.load_sharded`: this rank's
        window of each leaf with a ``mesh``, ``shardings`` or a template
        of windows; tensors on the template's devices, else on
        ``device``).

        With more than one process every rank restores the same step:
        each loads its newest good step, the ranks take the smallest
        (over the coordination store), and a rank above it loads again
        at most that step, until they agree; so one rank's corrupt shard
        sends every rank back to the same earlier step.

        Returns ``(state, step)``; ``(template, None)`` when no valid
        checkpoint exists.  A step that fails the full check is
        remembered, so :meth:`latest_step` reports the fallback."""
        self.wait()
        proc, world = self._rank_world()
        store = self._coordination_store(world)
        state, step = self._restore_newest(None, template, mesh, shardings,
                                           device)
        if world <= 1 or store is None:
            return state, step
        # the votes of a restore are fresh in the store: each rank counts
        # its restores of this root there (every manager on the root, in
        # one order on every rank), so no vote of an earlier one is read
        tag = f"restore/{self._tag()}"
        seq = store.add(f"{tag}/seq/{proc}", 1)
        tag = f"{tag}/{seq}"
        rnd = 0
        while True:
            key = f"{tag}/{rnd}"
            store.set(f"{key}/{proc}", str(-1 if step is None else step))
            steps = [int(store.get(f"{key}/{p}", wait=True,
                                   timeout=self.barrier_timeout))
                     for p in range(world)]
            rnd += 1
            agreed = min(steps)
            if agreed < 0:
                return template, None
            if all(s == agreed for s in steps):
                return state, step
            if step != agreed:
                logger.warning("checkpoint restore: rank %d loaded step %s, "
                               "the ranks agree on step %d", proc, step,
                               agreed)
                state, step = self._restore_newest(agreed, template, mesh,
                                                   shardings, device)

    def _restore_newest(self, bound, template, mesh, shardings, device):
        """The newest step at most ``bound`` (any when None) that loads
        clean on this rank, and its state."""
        tel = get_telemetry()
        for step in reversed(self.valid_steps()):
            if bound is not None and step > bound:
                continue
            d = self.step_dir(step)
            t0 = time.perf_counter()
            try:
                state = _ckpt.load_sharded(d, mesh, shardings, template,
                                           integrity=self.integrity,
                                           elastic=self.elastic,
                                           device=device)
                tel.record_checkpoint_restore(time.perf_counter() - t0,
                                              step=step)
                return state, step
            except (CheckpointCorruptError, FileNotFoundError,
                    ValueError) as e:
                tel.record_checkpoint_restore(time.perf_counter() - t0,
                                              step=step, ok=False)
                logger.warning(
                    "checkpoint step %d at %s failed verification (%s); "
                    "falling back to an earlier step", step, d, e)
                self._bad.add(step)
        return template, None

    def _coordination_store(self, world):
        """The store of multi-process saves and restores: the one given,
        else (more than one process, a process group up) the default
        process group's store."""
        if self.store is not None or world <= 1:
            return self.store
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return _ckpt.ProcessGroupStore.default()
        return None

    def _tag(self):
        """What keys this manager's store traffic: the run and the root
        (several managers may share one store)."""
        root = os.path.abspath(self.root).encode()
        return f"{self.run_id or '0'}.{zlib.crc32(root) & 0xFFFFFFFF:08x}"

    def load_data_state(self, step=None, process_index=None):
        """The ``data_state`` committed with ``save(..., data_state=)``
        for ``step`` (default: the newest valid step), or None."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        proc = process_index if process_index is not None \
            else self._rank_world()[0]
        path = os.path.join(self.step_dir(step), f"data_state.{proc}.json")
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    # -- retention ----------------------------------------------------------
    def _gc(self):
        """Keep the newest ``keep_last_n`` valid checkpoints: delete older
        committed ones, uncommitted or corrupt step dirs older than the
        newest valid one (a newer one may be a save in flight), and
        stale ``.tmp`` / ``.old`` staging dirs.  The newest valid
        checkpoint is never deleted."""
        if self.keep_last_n is None:
            return
        valid = self.valid_steps()
        if not valid:
            return
        newest = valid[-1]
        keep = set(valid[-self.keep_last_n:])
        deleted = 0
        for step, d in sorted(self._step_dirs().items()):
            if step in keep or step >= newest:
                continue
            shutil.rmtree(d, ignore_errors=True)
            deleted += 1
        for n in os.listdir(self.root):
            m = _TMP_RE.match(n)
            if m and int(m.group(1)) <= newest:
                shutil.rmtree(os.path.join(self.root, n),
                              ignore_errors=True)
                deleted += 1
        get_telemetry().record_checkpoint_gc(deleted)

    def close(self):
        self.wait()


def latest_checkpoint(root):
    """Path of the newest valid ``step_<n>`` checkpoint under ``root``,
    or None (also when ``root`` does not exist or holds no step
    directories)."""
    if not os.path.isdir(root):
        return None
    # a read-only probe: no janitor sweep from a path lookup
    mgr = CheckpointManager(root, keep_last_n=None, orphan_age=None)
    step = mgr.latest_step()
    return None if step is None else mgr.step_dir(step)
