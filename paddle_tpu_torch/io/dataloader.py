"""DataLoader (the counterpart of ``paddle_tpu/io/dataloader.py``).

Batches leave the loader as torch tensors on the CPU; the copy to the
card is the consumer's (``hapi.Model`` copies each batch to its
network's device).  Three ways to iterate:

 - single process: a thread assembles up to ``prefetch_factor`` batches
   ahead of the consumer;
 - an :class:`~.dataset.IterableDataset`: batches of ``batch_size``
   samples in the dataset's order, in the calling thread;
 - ``num_workers`` worker processes: batch ``i`` goes to worker ``i %
   num_workers``, at most ``prefetch_factor * num_workers`` batches ahead
   of the consumer; a thread takes the workers' batches off their queue
   as they arrive, and a reorder buffer hands them out in order.  Workers are spawned when
   the dataset and the collate function pickle, else forked; either way
   a worker collates on the CPU and never touches CUDA, so a parent
   holding a CUDA context can fork them.  A worker's batch crosses to
   the parent in shared memory (``torch.multiprocessing``'s tensor
   sharing: file descriptors whose segments are unlinked at creation,
   so nothing is left in ``/dev/shm``) unless ``use_shared_memory`` is
   false (then pickled bytes on the queue).  A worker that dies makes
   the next wait raise, naming the worker, its exit code and the last
   batch index sent to it; a worker's exception is re-raised in the
   parent with its traceback; ``timeout`` bounds each wait.  At the end
   of an epoch, or when the consumer stops early, the queue is drained
   while the workers are joined, and any still alive after 5 s are
   terminated.

``state_dict()`` / ``load_state_dict()`` resume an epoch after the
batches already *delivered* to the consumer (not the ones prefetched):
the batch sampler skips them as indices, fetching no data, so a resumed
run sees exactly the batches an uninterrupted one would.

With telemetry on (:mod:`..observability`), each wait of the consumer on
``next()`` is booked (``pt_data_wait_seconds``, ``pt_data_batches_total``).
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import pickle
import queue
import threading
import time
import traceback

import numpy as np
import torch

from ..observability.telemetry import get_telemetry
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info"]

_worker_info = threading.local()


class WorkerInfo:
    def __init__(self, id, num_workers, dataset=None, seed=0):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


def get_worker_info():
    """The :class:`WorkerInfo` of the worker process calling it, else
    None."""
    return getattr(_worker_info, "info", None)


def _as_tensor(a: np.ndarray):
    """A numeric array as a tensor sharing its memory; others as they
    are."""
    return torch.from_numpy(a) if a.dtype.kind in "biufc" else a


def default_collate_fn(batch):
    """Stack a list of samples into a batch of CPU tensors: arrays and
    tensors stacked, Python and numpy ints as int64, floats as f32,
    strings as a list, dicts, lists and tuples field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return _as_tensor(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        out = [default_collate_fn(list(col)) for col in zip(*batch)]
        return tuple(out) if isinstance(sample, tuple) else type(sample)(out)
    return _as_tensor(np.asarray(batch))


def _to_tensor_tree(obj):
    if isinstance(obj, np.ndarray):
        return _as_tensor(obj)
    if isinstance(obj, dict):
        return {k: _to_tensor_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_tensor_tree(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


class _Pickled:
    """A batch sent as pickled bytes (``use_shared_memory=False``)."""

    __slots__ = ("payload",)

    def __init__(self, data):
        self.payload = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id,
                 num_workers, seed, use_shared_memory, worker_init_fn):
    _worker_info.info = WorkerInfo(worker_id, num_workers, dataset, seed)
    np.random.seed((seed + worker_id) % (2 ** 31))
    torch.default_generator.manual_seed(seed + worker_id)
    torch.set_num_threads(1)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            break
        batch_id, indices = item
        try:
            data = collate_fn([dataset[i] for i in indices])
            if not use_shared_memory:
                data = _Pickled(data)
            data_queue.put((batch_id, data, None))
        except Exception:
            data_queue.put((batch_id, None, traceback.format_exc()))


def _get_checked(data_queue, workers, timeout, last_sent=None, stop=None):
    """``data_queue.get()`` that raises instead of hanging: when a worker
    has died (naming each dead worker, its pid, exit code and the last
    batch index sent to it) or after ``timeout`` seconds (0: none).
    Returns None once ``stop`` (an event) is set."""
    deadline = (time.monotonic() + timeout) if timeout else None
    while True:
        if stop is not None and stop.is_set():
            return None
        tick = 0.1
        if deadline is not None:
            tick = min(tick, max(0.01, deadline - time.monotonic()))
        try:
            return data_queue.get(timeout=tick)
        except queue.Empty:
            dead = [(wid, w) for wid, w in enumerate(workers)
                    if not w.is_alive()]
            if dead:
                detail = "; ".join(
                    f"worker {wid} (pid {w.pid}) exitcode {w.exitcode}, "
                    f"last dispatched batch index "
                    f"{(last_sent or {}).get(wid, 'none')}"
                    for wid, w in dead)
                raise RuntimeError(
                    f"DataLoader worker(s) exited unexpectedly: {detail}")
            if deadline is not None and time.monotonic() >= deadline:
                raise RuntimeError(
                    f"DataLoader timed out after {timeout}s waiting for a "
                    f"batch")


def _timed_iter(it, tel):
    """``it``, booking how long the consumer waited on each ``next()``
    (``pt_data_wait_seconds``, ``pt_data_batches_total``); installed only
    while telemetry is on."""
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        tel.data_wait(time.perf_counter() - t0)
        yield batch


class DataLoader:
    """Batches of ``dataset`` (the JAX package's signature; ``feed_list``,
    ``places``, ``use_buffer_reader`` and ``persistent_workers`` are
    accepted and not read).  See the module docstring."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.num_workers = max(0, int(num_workers))
        self.use_shared_memory = bool(use_shared_memory)
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_factor = max(1, prefetch_factor)
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.return_list = return_list
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        # batches handed to the consumer this epoch: the resume cursor
        self._delivered = 0

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()

    def __iter__(self):
        if self._iterable_mode:
            it = self._iter_iterable()
        elif self.num_workers == 0:
            it = self._iter_single()
        else:
            it = self._iter_multiprocess()
        it = self._counted(it)
        tel = get_telemetry()
        return _timed_iter(it, tel) if tel.enabled else it

    def _counted(self, it):
        # a resumed epoch counts on from the sampler's skip
        self._delivered = getattr(self.batch_sampler, "_resume_skip", 0)
        for batch in it:
            self._delivered += 1
            yield batch

    def state_dict(self):
        """The input pipeline's mid-epoch position, to save beside the
        model (``CheckpointManager.save(..., data_state=...)``): the
        delivered count, and the batch sampler's state with that count as
        its ``cursor``."""
        sd = {"delivered": self._delivered}
        bs = self.batch_sampler
        if bs is not None and hasattr(bs, "state_dict"):
            s = dict(bs.state_dict())
            s["cursor"] = self._delivered
            sd["sampler"] = s
        return sd

    def load_state_dict(self, state):
        """Resume at :meth:`state_dict`'s position: the next epoch begins
        after the batches already delivered, skipped as indices."""
        bs = self.batch_sampler
        samp = state.get("sampler")
        if bs is not None and samp is not None \
                and hasattr(bs, "load_state_dict"):
            bs.load_state_dict(samp)
        self._delivered = getattr(bs, "_resume_skip", 0) if bs is not None \
            else 0

    # -- one process, a prefetch thread -------------------------------------
    def _iter_single(self):
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield _to_tensor_tree(self.dataset[i])
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        stop = object()
        done = threading.Event()

        def produce():
            try:
                for indices in self.batch_sampler:
                    if done.is_set():
                        break
                    q.put(self.collate_fn([self.dataset[i]
                                           for i in indices]))
            except Exception:
                q.put(RuntimeError(traceback.format_exc()))
            finally:
                q.put(stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, RuntimeError):
                    raise item
                yield _to_tensor_tree(item)
        finally:
            # a consumer that stops early: let the producer finish its
            # put and see the flag
            done.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass

    def _iter_iterable(self):
        it = iter(self.dataset)
        if self.batch_size is None:
            for sample in it:
                yield _to_tensor_tree(sample)
            return
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield _to_tensor_tree(self.collate_fn(batch))

    # -- worker processes, a reorder buffer ----------------------------------
    def _iter_multiprocess(self):
        try:
            pickle.dumps((self.dataset, self.collate_fn,
                          self.worker_init_fn))
            ctx = mp.get_context("spawn")
        except Exception:
            ctx = mp.get_context("fork")
        index_queues = [ctx.Queue() for _ in range(self.num_workers)]
        data_queue = ctx.Queue()
        seed = np.random.randint(0, 2 ** 31)
        workers = []
        for wid in range(self.num_workers):
            w = ctx.Process(
                target=_worker_loop,
                args=(self.dataset, index_queues[wid], data_queue,
                      self.collate_fn, wid, self.num_workers, seed,
                      self.use_shared_memory, self.worker_init_fn),
                daemon=True)
            w.start()
            workers.append(w)
        try:
            batches = list(self.batch_sampler)
        except BaseException:
            _shut_down(workers, index_queues, data_queue)
            raise
        n = len(batches)
        last_sent: dict = {}     # worker id -> last batch index sent
        ready: queue.Queue = queue.Queue()   # (batch id, data) or an error
        freed = threading.Semaphore(0)       # one a batch handed out
        stop = threading.Event()

        def receive():
            # sends indices (batch i to worker i % num_workers), at most
            # prefetch_factor * num_workers ahead of the consumer, and
            # takes the workers' batches off the queue as they come, so a
            # batch is unpickled before the consumer asks for it
            sent = got = 0
            window = self.prefetch_factor * self.num_workers
            try:
                while got < n and not stop.is_set():
                    while sent < n and (sent < window or
                                        freed.acquire(blocking=False)):
                        wid = sent % self.num_workers
                        index_queues[wid].put((sent, batches[sent]))
                        last_sent[wid] = sent
                        sent += 1
                    if got == sent:          # all out: wait for a free slot
                        if freed.acquire(timeout=0.05):
                            freed.release()
                        continue
                    item = _get_checked(data_queue, workers, self.timeout,
                                        last_sent, stop)
                    if item is None:
                        return
                    batch_id, data, err = item
                    if err is not None:
                        raise RuntimeError(
                            f"DataLoader worker failed:\n{err}")
                    if isinstance(data, _Pickled):
                        data = pickle.loads(data.payload)
                    ready.put((batch_id, data))
                    got += 1
            except Exception as e:         # raised in the consumer
                ready.put(e)

        receiver = threading.Thread(target=receive, daemon=True)
        receiver.start()
        reorder: dict = {}
        try:
            next_yield = 0
            while next_yield < n:
                if next_yield in reorder:
                    data = reorder.pop(next_yield)
                    next_yield += 1
                    freed.release()
                    yield _to_tensor_tree(data)
                    continue
                item = ready.get()
                if isinstance(item, Exception):
                    raise item
                reorder[item[0]] = item[1]
        finally:
            stop.set()
            receiver.join()
            _shut_down(workers, index_queues, data_queue)


def _shut_down(workers, index_queues, data_queue):
    """Stop the workers: a sentinel to each, then drain the data queue
    while joining them (a worker's feeder thread may be blocked on a batch
    no one will read; joining first would terminate it mid-write), and
    terminate those still alive after 5 s.  A drained batch's shared
    memory goes with its last reference."""
    for q_ in index_queues:
        try:
            q_.put(None)
        except Exception:
            pass

    def drain():
        while True:
            try:
                data_queue.get_nowait()
            except Exception:
                break

    pending = list(workers)
    deadline = time.monotonic() + 5
    while pending and time.monotonic() < deadline:
        drain()
        for w in pending:
            w.join(timeout=0.2)
        pending = [w for w in pending if w.is_alive()]
    for w in pending:
        w.terminate()
        w.join(timeout=1)
    drain()
    for q_ in index_queues + [data_queue]:
        q_.cancel_join_thread()
        q_.close()
