"""Crash-consistent sharded checkpoints, readable by both packages.

The counterpart of ``paddle_tpu/distributed/checkpoint.py``, on the same
directory format, so a checkpoint written by either package loads in
the other with the same bits:

 - ``save_sharded(state, path)`` writes each leaf of a nested dict
   (torch tensors, numpy arrays, :class:`HostLocalShard` and
   :class:`ShardWindow` windows) as ``<ckpt>/data/<leaf>/<proc>_<k>.npy``
   plus ``index.<proc>.json`` (global shape, dtype, spec, each shard
   file's index window and its content digest).  A torch tensor is one
   shard, the whole array, as a JAX array on one device is.  A
   :class:`ShardWindow` is one rank's window of a sharded array with the
   array's spec in the JAX package's JSON form; only the rank that holds
   replica 0 of a window writes it (the JAX package's ``replica_id``
   skip), so the windows of a multi-rank save cover each leaf exactly
   once, which loads check.
 - ``load_sharded(path, mesh=None, shardings=None, template=None)``
   verifies the checkpoint, then assembles each leaf from the shard
   files that cover it (each file read once, several at a time) and
   returns a nested dict of tensors: on the template leaf's device, else
   on ``device`` (the CPU by default).  With a ``mesh`` (or a template
   of :class:`ShardWindow` leaves) each rank gets its own window of each
   leaf and reads and verifies only the shard files that window meets;
   pipeline-stacked ``__ppstack__`` leaves and per-block leaves are
   translated into each other in either direction, at any number of
   virtual stages.  ``load_state(path, state)`` copies a checkpoint into
   the live tensors of ``state`` in place (a captured step and the
   kernels' TMA maps keep the addresses they baked in).

Crash consistency, as in the JAX package: every payload write is
fsynced, a ``COMMIT.<proc>`` marker (a manifest of each file's CRC32
and size) is written last; a single writer stages into
``<path>.tmp.<nonce>`` and commits by one atomic rename; writers of a
multi-process save with a coordination ``store`` (any object with
``set(key, value)``, ``get(key, wait=, timeout=)`` returning None for an
absent key, and ``add(key, n)``) stage into one shared directory,
barrier on the markers (:func:`store_barrier`) and rank 0 promotes; a
store-less multi-process save commits in place, marker by marker.
Loads verify the markers, each file's size and CRC, each leaf's window
coverage and each shard's content digest before building a tensor, and
raise :class:`CheckpointCorruptError` naming the leaf or file.
``elastic=True`` stitches a checkpoint of another world size from the
committed ranks' windows (:class:`ReshardError` on a hole).

bf16 on disk: the JAX package writes an ``ml_dtypes.bfloat16`` array
through ``np.save`` (descr ``'<V2'``, index dtype ``"bfloat16"``).  The
port writes the same header over the tensor's 2-byte elements and reads
``'<V2'`` back through a uint16 -> int16 -> ``torch.bfloat16`` view;
the content digest is taken over those same bytes.

Every byte that must survive a crash goes through :func:`_write_file`
and :func:`_replace_dir`, the seam a fault-injection test patches.
"""
from __future__ import annotations

import io as _io
import itertools
import json
import logging
import os
import re
import shutil
import time
import uuid
import zlib
import numpy as np
import torch

from ..observability.telemetry import get_telemetry
from ..utils.retry import retry_call, wait_until
from .auto_parallel.spec_layout import spec_axes

__all__ = ["save_sharded", "load_sharded", "save_state", "load_state",
           "CheckpointCorruptError", "ReshardError", "HostLocalShard",
           "ShardWindow", "ProcessGroupStore", "is_committed",
           "verify_checkpoint", "store_barrier", "sweep_staging",
           "read_leaf", "process_index", "world_size", "spec_window",
           "rank_payload_bytes"]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

_COMMIT_RE = re.compile(r"^COMMIT\.(\d+)$")
_STAGING_RE = re.compile(r"\.(tmp|old)\.[0-9a-fA-F]+$")
_BF16 = "bfloat16"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed commit/integrity verification:
    missing COMMIT markers, a missing/truncated/bit-flipped shard file,
    or shard windows that do not cover a leaf's full shape."""


class ReshardError(CheckpointCorruptError):
    """An elastic resume could not re-shard the checkpoint: the windows
    of the committed ranks leave a hole in some leaf.  A subclass of
    :class:`CheckpointCorruptError`, so resume-from-latest falls back
    past such a step."""


def process_index() -> int:
    """This process's rank: ``torch.distributed``'s when a process
    group is up, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def world_size() -> int:
    """The number of processes: ``torch.distributed``'s when a process
    group is up, else 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# save_sharded's arguments of the same names shadow the two functions
_rank, _world = process_index, world_size


def _to_numpy(x) -> np.ndarray:
    """A host array of ``x``'s elements; a bf16 tensor as its 2-byte
    elements (an int16 array), which the writer records as bf16.  A
    CUDA tensor is copied to the host (the copy waits for the card); a
    CPU tensor or an array is viewed, not copied."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    """The index's dtype string, the JAX package's own (``float32``,
    ``bfloat16``, ``int32``, ``int8``, ``uint8``, ...)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty((), dtype=x.dtype).numpy().dtype)
    return str(np.asarray(x).dtype)


class HostLocalShard:
    """This process's window of a logically global array.

    For multi-process jobs without a global device mesh: ``save_sharded``
    records the declared ``global_shape`` and ``window`` (``[[start,
    stop], ...]`` per dimension, the full shape by default: a replicated
    leaf), so N processes jointly write one checkpoint that loads at any
    world size.  ``data`` is an array or a tensor (a bf16 tensor keeps
    its dtype)."""

    __slots__ = ("data", "dtype", "window", "global_shape")

    def __init__(self, data, window=None, global_shape=None):
        self.dtype = _dtype_name(data)
        self.data = _to_numpy(data)
        self.global_shape = tuple(
            int(d) for d in (self.data.shape if global_shape is None
                             else global_shape))
        if window is None:
            window = [[0, d] for d in self.data.shape]
        self.window = [[int(a), int(b)] for a, b in window]
        if len(self.window) != len(self.global_shape):
            raise ValueError(
                f"window rank {len(self.window)} != global rank "
                f"{len(self.global_shape)}")
        for (a, b), dim in zip(self.window, self.global_shape):
            if not (0 <= a <= b <= dim):
                raise ValueError(f"window {self.window} out of bounds "
                                 f"for global shape {self.global_shape}")
        want = tuple(b - a for a, b in self.window)
        if want != tuple(self.data.shape):
            raise ValueError(f"data shape {self.data.shape} does not "
                             f"fill window {self.window}")


class ShardWindow:
    """One rank's window of a sharded array, the counterpart of one
    addressable shard of a JAX array on a mesh.

    ``window`` (``[[start, stop], ...]`` a dimension) places the data in
    the array of ``global_shape``; ``spec`` is the array's
    ``PartitionSpec`` in the JAX package's JSON form (a list, one entry a
    dimension: None, an axis name or a list of names); ``write`` is
    false on a rank that holds a replica of a window another rank writes.
    The data are the live tensors, not a copy: ``parts`` is a list of
    ``(index, tensor)``, each tensor the part of the window at ``index``
    (``()`` for the whole window), so a window made of several tensors,
    a pipeline stage's blocks stacked, is assembled only when it is
    written (:meth:`tensor`) and a load copies back into the parts in
    place (:meth:`assign`).  As a template leaf of :func:`load_sharded`
    it asks for that window of the saved leaf."""

    __slots__ = ("parts", "window", "global_shape", "spec", "write",
                 "shape", "torch_dtype", "device")

    def __init__(self, data=None, window=None, global_shape=None,
                 spec=None, write=True, *, parts=None):
        self.parts = [((), data)] if parts is None else list(parts)
        first = self.parts[0][1]
        self.global_shape = tuple(int(d) for d in global_shape)
        self.window = [[int(a), int(b)] for a, b in window]
        self.shape = tuple(b - a for a, b in self.window)
        if len(self.window) != len(self.global_shape) or any(
                not 0 <= a <= b <= d
                for (a, b), d in zip(self.window, self.global_shape)):
            raise ValueError(f"window {self.window} out of bounds for "
                             f"global shape {self.global_shape}")
        if parts is None and tuple(first.shape) != self.shape:
            raise ValueError(f"data shape {tuple(first.shape)} does not "
                             f"fill window {self.window}")
        self.spec = None if spec is None else _spec_to_json(spec)
        self.write = bool(write)
        self.torch_dtype, self.device = first.dtype, first.device

    @property
    def dtype(self) -> str:
        return _dtype_name(torch.empty((), dtype=self.torch_dtype))

    def tensor(self) -> torch.Tensor:
        """The window's data as one tensor (the live tensor itself when
        the window is one part)."""
        if len(self.parts) == 1 and self.parts[0][0] == ():
            return self.parts[0][1].detach()
        out = torch.empty(self.shape, dtype=self.torch_dtype,
                          device=self.device)
        with torch.no_grad():
            for idx, t in self.parts:
                out[idx] = t
        return out

    @torch.no_grad()
    def assign(self, value: torch.Tensor) -> None:
        """Copy ``value`` (the window's shape) into the parts in place."""
        if tuple(value.shape) != self.shape:
            raise ValueError(f"window {self.window}: got shape "
                             f"{tuple(value.shape)}, want {self.shape}")
        for idx, t in self.parts:
            if value.dtype != t.dtype:
                raise ValueError(f"window {self.window}: checkpoint "
                                 f"{value.dtype}, live {t.dtype}")
            t.copy_(value[idx])


def _spec_to_json(spec):
    """A spec (tuple or list; entries None, a name, or a tuple or list
    of names) as the JSON list the JAX package writes."""
    if spec is None:
        return None
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


def _target_spec(saved_spec, shape, mesh):
    """The saved spec adapted to the loading mesh (the JAX package's
    rule): axes the mesh lacks or has at size 1 dropped, a dimension the
    kept axes do not divide replicated."""
    if saved_spec is None:
        return ()
    out = []
    for d, e in enumerate(saved_spec):
        kept = tuple(a for a in spec_axes(e) if mesh.shape.get(a, 1) > 1)
        size = int(np.prod([mesh.shape[a] for a in kept])) if kept else 1
        if kept and d < len(shape) and shape[d] % size == 0:
            out.append(kept if len(kept) > 1 else kept[0])
        else:
            out.append(None)
    return tuple(out)


def spec_window(spec, shape, mesh, coords):
    """The window of an array of ``shape`` that the rank at mesh
    coordinates ``coords`` ({axis: index}) holds under ``spec``: each
    dimension split evenly over the product of its axes, the first axis
    the major one (``NamedSharding``'s placement)."""
    win = []
    spec = list(spec or ())
    for d, dim in enumerate(shape):
        names = [a for a in spec_axes(spec[d] if d < len(spec) else None)
                 if mesh.shape.get(a, 1) > 1]
        size, idx = 1, 0
        for a in names:
            idx = idx * mesh.shape[a] + coords.get(a, 0)
            size *= mesh.shape[a]
        if dim % size:
            raise ValueError(f"dimension {d} of shape {tuple(shape)} does "
                             f"not split over {names} ({size})")
        w = dim // size
        win.append([idx * w, (idx + 1) * w])
    return win


_SEP = "."  # flattened-tree key separator


def _esc(key):
    return key.replace("\\", "\\\\").replace(_SEP, "\\u002e")


def _unesc(key):
    return key.replace("\\u002e", _SEP).replace("\\\\", "\\")


def _unflatten(flat):
    """The nested dict of ``{leaf key: value}``; keys were escaped
    (:func:`_esc`), so splitting on the separator is exact although
    parameter names hold dots."""
    tree = {}
    for k, v in flat.items():
        parts = [_unesc(p) for p in k.split(_SEP)]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flat_items(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_items(v, path + (str(k),))
    else:
        yield path, tree


def _leaf_name(path):
    return _SEP.join(_esc(p) for p in path)


def _fs_name(leaf):
    """Filesystem-safe directory name for a leaf key."""
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", leaf)


# -- durable write plumbing -------------------------------------------------
# Every byte that must survive a crash goes through _write_file and
# _replace_dir; a fault-injection test patches exactly these two.

def _write_file(path, data, durable=True):
    """Write ``data`` bytes to ``path`` and fsync before returning."""
    with open(path, "wb") as f:
        f.write(data)
        if durable:
            f.flush()
            os.fsync(f.fileno())


def _fsync_dir(path):
    """fsync a directory so freshly created entries survive a crash."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # not supported (some network filesystems): best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _replace_dir(tmp, final):
    """Atomically promote ``tmp`` to ``final`` by ``os.rename``; an
    existing ``final`` is swapped out and removed after the new one is
    in place."""
    if os.path.isdir(final):
        old = f"{final}.old.{os.path.basename(tmp).rsplit('.', 1)[-1]}"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)
    _fsync_dir(os.path.dirname(os.path.abspath(final)))


def _npy_bytes(arr, dtype):
    """The ``.npy`` file of ``arr`` (as ``np.save`` writes it, built with
    one copy of the elements); bf16 (``arr`` its int16 view) with the
    descr ``'<V2'`` that ``np.save`` gives an ``ml_dtypes.bfloat16``
    array, so both packages write the same bytes."""
    arr = np.require(arr, requirements="C")
    head = np.lib.format.header_data_from_array_1_0(arr)
    if dtype == _BF16:
        head["descr"] = "<V2"
    buf = _io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, head)
    head = buf.getvalue()
    out = np.empty(len(head) + arr.nbytes, np.uint8)   # a bytes-like buffer
    out[:len(head)] = np.frombuffer(head, np.uint8)
    out[len(head):] = arr.reshape(-1).view(np.uint8)
    return out


def _content_digest(arr):
    """CRC32 over the element bytes of one shard, taken from the live
    array at save, before serialization (for bf16 its 2-byte elements).

    Distinct from the COMMIT manifest's per-file CRC on purpose: that
    one is computed over the ``.npy`` buffer, so corruption between
    device memory and serialization is sealed into the manifest; the
    content digest can only be reproduced by the element bytes that were
    alive in the tree at save."""
    return zlib.crc32(np.require(arr, requirements="C").reshape(-1).view(
        np.uint8)) & 0xFFFFFFFF


def _snapshot(state):
    """``state`` with every leaf a host array of its own (a copy): what
    an asynchronous save serializes while the caller goes on updating
    the live tensors in place.  CUDA tensors are copied together and
    waited for once."""
    flat = list(_flat_items(state))
    out = {}
    for p, x in flat:
        if isinstance(x, ShardWindow):
            if not x.write:
                continue
            t = x.tensor()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            host.copy_(t, non_blocking=t.is_cuda)
            out[p] = ShardWindow(host, x.window, x.global_shape, x.spec)
        elif isinstance(x, HostLocalShard):
            copy = HostLocalShard.__new__(HostLocalShard)
            copy.dtype, copy.window = x.dtype, x.window
            copy.global_shape = x.global_shape
            copy.data = np.array(x.data, copy=True)
            out[p] = copy
        elif isinstance(x, torch.Tensor):
            t = x.detach()
            host = torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=t.is_cuda)
            host.copy_(t, non_blocking=t.is_cuda)
            out[p] = host
        else:
            out[p] = np.array(x, copy=True)
    if any((isinstance(x, torch.Tensor) and x.is_cuda) or
           (isinstance(x, ShardWindow) and x.device.type == "cuda")
           for _, x in flat):
        torch.cuda.synchronize()
    return _unflatten({_leaf_name(p): v for p, v in out.items()})


def _shard_records(state, proc):
    """Yield ``(relpath, data)`` for every durable file of this
    process's part of the checkpoint: each leaf as
    ``data/<leaf>/<proc>_<k>.npy``, then ``index.<proc>.json`` last (an
    index never lands before the shards it points at).  ``data`` is a
    bytes-like object or a function that builds one (the ``.npy`` file,
    taking the content digest on the way), so a writer may build files
    in parallel; the host copy of each leaf is taken here."""
    index = {}
    for p, x in _flat_items(state):
        leaf = _leaf_name(p)
        fs = _fs_name(leaf)
        fname = f"{proc}_0.npy"
        spec = None
        if isinstance(x, ShardWindow):
            if not x.write:          # a replica another rank writes
                continue
            dtype, data = x.dtype, _to_numpy(x.tensor())
            shape, window = list(x.global_shape), [list(w) for w in x.window]
            spec = x.spec
        elif isinstance(x, HostLocalShard):
            data, dtype = x.data, x.dtype
            shape, window = list(x.global_shape), [list(w) for w in x.window]
        else:
            dtype = _dtype_name(x)
            data = _to_numpy(x)
            shape = list(data.shape)
            # a 0-d leaf has the window []
            window = [[0, int(d)] for d in data.shape]
        shard = {"file": f"{fs}/{fname}", "index": window, "digest": None}
        index[leaf] = {"shape": shape, "dtype": dtype, "spec": spec,
                       "shards": [shard]}

        def build(data=data, dtype=dtype, shard=shard):
            shard["digest"] = _content_digest(data)
            return _npy_bytes(data, dtype)
        yield (f"data/{fs}/{fname}", build)
    yield (f"index.{proc}.json", lambda: json.dumps(index).encode())


#: threads that build, checksum, write and read a checkpoint's files
#: (zlib, file I/O and numpy's copies run without the GIL)
_IO_THREADS = min(8, os.cpu_count() or 1)


def _write_one(root, rel, data, durable):
    if callable(data):
        data = data()
    _write_file(os.path.join(root, rel), data, durable=durable)
    return {"crc32": zlib.crc32(data) & 0xFFFFFFFF, "size": len(data)}


def _write_records(root, records, durable=True):
    """Write ``(relpath, data)`` records under ``root``, up to
    ``_IO_THREADS`` at a time (an index record only once every record
    before it has landed); returns the integrity manifest ``{relpath:
    {"crc32": ..., "size": ...}}`` in record order.  A failed write stops
    the submissions and is raised once the writes in flight have
    ended."""
    from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
    made, futures = set(), {}
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        for rel, data in records:
            d = os.path.dirname(os.path.join(root, rel))
            if d not in made:
                os.makedirs(d, exist_ok=True)
                made.add(d)
            if rel.startswith("index."):
                wait(futures.values())
            else:
                busy = [f for f in futures.values() if not f.done()]
                if len(busy) >= _IO_THREADS:
                    wait(busy, return_when=FIRST_COMPLETED)
            if any(f.done() and f.exception() is not None
                   for f in futures.values()):
                break
            futures[rel] = pool.submit(_write_one, root, rel, data, durable)
    return {rel: f.result() for rel, f in futures.items()}


def _write_commit_marker(root, proc, world, manifest, durable=True,
                         nonce=None):
    marker = {"format": 1, "proc": proc, "world": world, "files": manifest}
    if nonce:
        marker["nonce"] = nonce
    _write_file(os.path.join(root, f"COMMIT.{proc}"),
                json.dumps(marker).encode(), durable=durable)
    _fsync_dir(root)


def _committed_nonce(path):
    """The staging nonce in ``path``'s COMMIT markers, or None when the
    directory is absent, not fully committed, or has none."""
    try:
        markers = _read_markers(path)
    except (FileNotFoundError, CheckpointCorruptError):
        return None
    return next(iter(markers.values())).get("nonce")


def _save_records(records, path, proc, world, store=None, durable=True,
                  nonce=None, run_id=None, barrier_timeout=300.0):
    """The commit protocol over serialized records (shared by
    :func:`save_sharded` and the CheckpointManager's writer)."""
    if world <= 1:
        # one writer: stage in <path>.tmp.<nonce>, commit by rename; the
        # checkpoint appears at `path` whole or not at all
        nonce = nonce or uuid.uuid4().hex[:8]
        tmp = f"{path}.tmp.{nonce}"
        shutil.rmtree(tmp, ignore_errors=True)
        manifest = _write_records(tmp, records, durable=durable)
        _write_commit_marker(tmp, proc, world, manifest, durable=durable,
                             nonce=nonce)
        _replace_dir(tmp, path)
    elif store is not None:
        # every process writes into ONE staging dir (its nonce published
        # by rank 0, fresh for each attempt), barrier on all COMMIT
        # markers, then rank 0 promotes with one rename; a crash at any
        # phase leaves only `.tmp.<nonce>` debris for the janitor.  The
        # keys of a save are fresh in the store: each process counts its
        # saves of this path there, and all save in one order, so a
        # second save to a path never reads the first one's nonce
        base = os.path.basename(path)
        tag = f"ckpt/{run_id or '0'}/{base}"
        seq = store.add(f"{tag}/seq/{proc}", 1)
        tag = f"{tag}/{seq}"
        if proc == 0:
            nonce = nonce or uuid.uuid4().hex[:8]
            store.set(f"{tag}/nonce", nonce)
        else:
            got = store.get(f"{tag}/nonce", wait=True,
                            timeout=barrier_timeout)
            nonce = got.decode() if isinstance(got, bytes) else str(got)
        tmp = f"{path}.tmp.{nonce}"
        manifest = _write_records(tmp, records, durable=durable)
        _write_commit_marker(tmp, proc, world, manifest, durable=durable,
                             nonce=nonce)
        store_barrier(store, f"{tag}/{nonce}/commit", world, rank=proc,
                      timeout=barrier_timeout)
        if proc == 0:
            _replace_dir(tmp, path)
            store.set(f"{tag}/{nonce}/promoted", b"1")
        else:
            # rank 0 may die between rename and flag: the marker nonce in
            # the final dir is the authoritative promote signal
            wait_until(
                lambda: (store.get(f"{tag}/{nonce}/promoted", wait=False)
                         is not None
                         or _committed_nonce(path) == nonce),
                barrier_timeout,
                desc=f"checkpoint promote of {base} (nonce {nonce})")
    else:
        # no store, a shared filesystem: each process writes its files in
        # place; the checkpoint is committed once ALL COMMIT markers
        # exist (a crashed attempt leaves a partial marker set, which
        # sweep_staging removes once aged)
        os.makedirs(path, exist_ok=True)
        manifest = _write_records(path, records, durable=durable)
        _write_commit_marker(path, proc, world, manifest, durable=durable)


def save_sharded(state, path, process_index=None, *, world_size=None,
                 store=None, durable=True, run_id=None,
                 barrier_timeout=300.0):
    """Save a nested dict of tensors (arrays, :class:`HostLocalShard`
    windows) as a crash-consistent checkpoint directory.

    ``process_index`` / ``world_size`` default to ``torch.distributed``'s
    rank and size (0 and 1 without a process group).  One writer saves
    atomically (stage + rename); several with a ``store`` use the staged
    protocol, ``run_id`` (default ``$PT_RUN_ID``) isolating the barrier
    keys of relaunches; several without one commit in place.
    ``durable=False`` skips fsyncs (tests, throwaway dirs)."""
    proc = _rank() if process_index is None else process_index
    world = _world() if world_size is None else world_size
    _save_records(_shard_records(state, proc), path, proc, world,
                  store=store, durable=durable,
                  run_id=run_id or os.environ.get("PT_RUN_ID"),
                  barrier_timeout=barrier_timeout)



class ProcessGroupStore:
    """The coordination-store protocol of this module over a
    ``torch.distributed.Store`` (``set``, ``add``, ``check`` and ``get``):
    ``get(key, wait=False)`` returns None for an absent key,
    ``get(key, wait=True, timeout=s)`` polls until the key is set and
    raises ``TimeoutError`` after ``s`` seconds.  :meth:`default` wraps
    the store of the default process group."""

    def __init__(self, store):
        self.store = store

    @classmethod
    def default(cls) -> "ProcessGroupStore":
        from torch.distributed import distributed_c10d
        return cls(distributed_c10d._get_default_store())

    def set(self, key, value):
        self.store.set(key, value)

    def add(self, key, n):
        return self.store.add(key, n)

    def get(self, key, wait=True, timeout=None):
        if not wait:
            return self.store.get(key) if self.store.check([key]) else None
        wait_until(lambda: self.store.check([key]), timeout,
                   desc=f"store key {key!r}")
        return self.store.get(key)


def _barrier_arrive(store, key, rank=None):
    """Announce this process at the barrier (the per-rank key lets a
    timeout name who never arrived)."""
    if rank is not None:
        store.set(f"{key}/rank/{rank}", b"1")
    return store.add(key, 1)


def store_barrier(store, key, world, rank=None, timeout=300.0):
    """Block until ``world`` processes have entered this barrier: after
    it returns, every process's COMMIT marker is on the shared
    filesystem.

    With ``rank``, the seal is the set of idempotent per-rank arrival
    keys (a retried arrival that bumps the counter twice cannot release
    the barrier early), and a timeout names the ranks that never
    arrived; ``rank=None`` keeps the counter-only contract (stores that
    only implement ``add``).  A transient ``ConnectionError``,
    ``TimeoutError`` or ``OSError`` while arriving or polling is retried
    within ``timeout``."""
    transient = (ConnectionError, TimeoutError, OSError)

    def _missing_ranks():
        try:
            arrived = sorted(
                p for p in range(world)
                if store.get(f"{key}/rank/{p}", wait=False) is not None)
        except transient as e:
            return (f"store unreachable while probing arrivals "
                    f"({type(e).__name__}: {e})")
        missing = sorted(set(range(world)) - set(arrived))
        return (f"{len(arrived)}/{world} ranks arrived; missing ranks "
                f"{missing} (arrived: {arrived})")

    arrived_cache: set = set()

    def _sealed():
        try:
            if rank is not None:
                for p in range(world):
                    if p not in arrived_cache and store.get(
                            f"{key}/rank/{p}", wait=False) is not None:
                        arrived_cache.add(p)
                return len(arrived_cache) >= world
            return store.add(key, 0) >= world
        except transient as e:
            logger.warning(
                "checkpoint barrier %r: transient store error while "
                "polling (%s: %s); retrying within deadline",
                key, type(e).__name__, e)
            return False

    t0 = time.monotonic()
    ok = False
    try:
        retry_call(_barrier_arrive, store, key, rank, retry_on=transient,
                   deadline=timeout, base=0.05, max_delay=1.0)
        remaining = max(0.0, timeout - (time.monotonic() - t0))
        wait_until(_sealed, remaining,
                   desc=f"checkpoint barrier {key!r} ({world} procs)",
                   diag=_missing_ranks if rank is not None else None)
        ok = True
    finally:
        get_telemetry().record_barrier_wait(time.monotonic() - t0, ok=ok)


# -- commit / integrity verification ----------------------------------------

def _read_markers(path, elastic=False):
    """Parse every COMMIT.<proc> marker under ``path``; raises
    CheckpointCorruptError when none exist, any is unreadable, or
    (unless ``elastic``) the set is short of the recorded world size."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    markers = {}
    for n in os.listdir(path):
        m = _COMMIT_RE.match(n)
        if not m:
            continue
        try:
            with open(os.path.join(path, n)) as f:
                markers[int(m.group(1))] = json.load(f)
        except (OSError, ValueError) as e:
            if elastic:
                logger.warning("%s: skipping unreadable commit marker "
                               "%s for elastic resume: %s", path, n, e)
                continue
            raise CheckpointCorruptError(
                f"{path}: unreadable commit marker {n}: {e}")
    if not markers:
        raise CheckpointCorruptError(
            f"{path}: no COMMIT marker — checkpoint was never committed "
            f"(save crashed mid-write?)")
    world = max(mk.get("world", 1) for mk in markers.values())
    missing = [p for p in range(world) if p not in markers]
    if missing:
        if not elastic:
            raise CheckpointCorruptError(
                f"{path}: partially committed checkpoint: COMMIT markers "
                f"present for ranks {sorted(markers)} but the recorded "
                f"world_size={world} expects ranks "
                f"{list(range(world))}; missing ranks {missing}. If the "
                f"fleet changed size or lost hosts, resume elastically "
                f"(load_sharded(..., elastic=True) / "
                f"CheckpointManager(..., elastic=True)) to re-shard from "
                f"the committed ranks' shard windows")
        logger.warning(
            "%s: elastic resume from a partial commit — using ranks %s "
            "of world_size=%d (missing %s); leaf coverage will be "
            "verified before any tensor is built",
            path, sorted(markers), world, missing)
    return markers


def _verify_manifest(path, markers, elastic=False):
    """Check every manifested file for existence and size; an index file
    outside every manifest is corruption too (debris of an aborted
    multi-process save), except under ``elastic``, where non-committed
    ranks' files are ignored.  Returns the merged manifest."""
    manifest = {}
    for mk in markers.values():
        manifest.update(mk.get("files", {}))
    for rel, want in manifest.items():
        fp = os.path.join(path, rel)
        if not os.path.exists(fp):
            raise CheckpointCorruptError(
                f"{path}: manifested file {rel} is missing")
        size = os.path.getsize(fp)
        if size != want["size"]:
            raise CheckpointCorruptError(
                f"{path}: {rel} truncated/resized: {size} bytes on disk, "
                f"{want['size']} in manifest")
    if not elastic:
        for n in os.listdir(path):
            if n.startswith("index.") and n.endswith(".json") \
                    and n not in manifest:
                raise CheckpointCorruptError(
                    f"{path}: index file {n} is not covered by any COMMIT "
                    f"manifest (debris of an aborted save?)")
    return manifest


def _read_file(path, rel, want=None):
    """A checkpoint file's bytes (a bytearray), read once; with ``want``
    (its manifest entry) its CRC32 checked."""
    fp = os.path.join(path, rel)
    data = bytearray(os.path.getsize(fp))
    with open(fp, "rb") as f:
        view, got = memoryview(data), 0
        while got < len(data):
            n = f.readinto(view[got:])
            if not n:
                break
            got += n
    if want is not None and (got != want["size"] or zlib.crc32(data)
                             & 0xFFFFFFFF != want["crc32"]):
        raise CheckpointCorruptError(
            f"{path}: {rel} failed CRC32 check (bit rot or partial write)")
    return data


def _npy_array(path, leaf, sh, data, digest=True):
    """The array of one shard file's bytes (a view of them); with
    ``digest``, its content digest checked against the one recorded
    from the live array at save (shards of older checkpoints have
    none)."""
    try:
        buf = _io.BytesIO(data[:min(len(data), 1 << 16)])
        version = np.lib.format.read_magic(buf)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(buf)
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(data, dtype, count=count, offset=buf.tell())
        arr = arr.reshape(shape, order="F" if fortran else "C")
    except Exception as e:
        raise CheckpointCorruptError(
            f"{path}: leaf '{leaf}' shard {sh['file']} is unreadable: "
            f"{e}") from e
    want = sh.get("digest")
    if digest and want is not None:
        got = _content_digest(arr)
        if got != int(want):
            raise CheckpointCorruptError(
                f"{path}: leaf '{leaf}' shard {sh['file']} failed its "
                f"content digest check (recorded {int(want):#010x} from "
                f"the live array at save, reconstructed {got:#010x}) — "
                f"silent corruption between device memory and restore")
    return arr


def _overlap(a, b) -> bool:
    """Whether two windows share an element (0-d windows always do)."""
    return all(max(x0, y0) < min(x1, y1) for (x0, x1), (y0, y1) in zip(a, b))


def _verify_coverage(path, leaf, entry, elastic=False, committed=None):
    """Every shard window in bounds, and the windows jointly covering
    the full shape.  The windows of a sharded leaf (one with a spec,
    which only replica-0 holders write) must not meet: a window written
    twice is corruption even when the volumes add up.  Coverage is then
    the volume of the distinct windows (replicated windows of spec-less
    leaves repeat whole)."""
    shape = tuple(entry["shape"])
    total = int(np.prod(shape)) if shape else 1
    exc = ReshardError if elastic else CheckpointCorruptError
    if not entry["shards"]:
        raise exc(f"{path}: leaf '{leaf}' has no shard files")
    boxes = []
    for sh in entry["shards"]:
        win = sh["index"]
        if len(win) != len(shape):
            raise CheckpointCorruptError(
                f"{path}: leaf '{leaf}' shard {sh['file']} window rank "
                f"{len(win)} != array rank {len(shape)}")
        for (a, b), dim in zip(win, shape):
            if not (0 <= a < b <= dim):
                raise CheckpointCorruptError(
                    f"{path}: leaf '{leaf}' shard {sh['file']} window "
                    f"{win} out of bounds for shape {list(shape)}")
        boxes.append(tuple(tuple(w) for w in win))
    if entry.get("spec") is not None:
        for i, j in itertools.combinations(range(len(boxes)), 2):
            if _overlap(boxes[i], boxes[j]):
                raise CheckpointCorruptError(
                    f"{path}: leaf '{leaf}' windows {list(boxes[i])} "
                    f"({entry['shards'][i]['file']}) and {list(boxes[j])} "
                    f"({entry['shards'][j]['file']}) overlap: a window of a "
                    f"sharded array written twice")
    covered = sum(int(np.prod([b - a for a, b in box]))
                  for box in set(boxes))
    if covered < total:
        if elastic:
            raise ReshardError(
                f"{path}: cannot re-shard leaf '{leaf}': the windows of "
                f"committed ranks {committed} cover only {covered} of "
                f"{total} elements of shape {list(shape)} — the missing "
                f"ranks' shard files are required and a zero-fill would "
                f"silently corrupt the state")
        raise CheckpointCorruptError(
            f"{path}: leaf '{leaf}' shards cover {covered} of {total} "
            f"elements — missing shard files for shape {list(shape)}")


def is_committed(path):
    """True iff ``path`` holds a fully committed checkpoint (every
    ``COMMIT.<proc>`` marker present and parseable).  Cheap: no CRC."""
    try:
        _read_markers(path)
        return True
    except (FileNotFoundError, CheckpointCorruptError):
        return False


def _open(path, integrity="full", elastic=False):
    """The markers, the merged manifest (sizes checked at "size" and
    "full") and the merged index of a checkpoint; at "full" every
    manifested file that is not shard data has its CRC32 checked (a bad
    index names its file)."""
    markers = _read_markers(path, elastic=elastic)
    manifest = _verify_manifest(path, markers, elastic=elastic) \
        if integrity in ("full", "size") else {}
    if integrity == "full":
        for rel in manifest:
            if not rel.startswith("data/"):
                _read_file(path, rel, manifest[rel])
    return markers, manifest, _merge_index(path, procs=sorted(markers))


def _check(path, integrity="full", elastic=False, leaves=(), scope=None,
           windows=None, opened=None):
    """Verify a checkpoint at ``integrity`` and read the shards of
    ``leaves``: the markers; the manifest's sizes ("size" and "full");
    every manifested file's CRC32 and, for the leaves of ``scope`` (all
    by default), each shard's content digest and the windows' coverage
    ("full"; "size" checks coverage only; "off" nothing more).  Each
    file is read once, ``_IO_THREADS`` at a time.  ``leaves``: leaf keys,
    or a predicate on them.  ``windows`` ({leaf: [window, ...]}): read,
    and at "full" verify, only the shard files of ``leaves`` that meet
    one of their leaf's windows, and no other file.  ``opened``:
    :func:`_open`'s result, when the caller has it.  Returns (the merged
    index, {shard file: array} for ``leaves``)."""
    from concurrent.futures import ThreadPoolExecutor
    markers, manifest, index = opened or _open(path, integrity, elastic)
    full = integrity == "full"
    if callable(leaves):
        leaves = [leaf for leaf in index if leaves(leaf)]
    for leaf in leaves:
        if leaf not in index:
            raise KeyError(f"{path}: no leaf {leaf!r} "
                           f"(have: {sorted(index)[:16]})")
    leaves = set(leaves)
    scope = set(index if scope is None else scope)
    if integrity in ("full", "size"):
        for leaf in sorted(scope):
            _verify_coverage(path, leaf, index[leaf], elastic=elastic,
                             committed=sorted(markers))
    shard_of = {"data/" + sh["file"]: (leaf, sh)
                for leaf, entry in index.items() for sh in entry["shards"]}

    def needed(leaf, sh):
        if leaf not in leaves:
            return False
        if windows is None or leaf not in windows:
            return True
        return any(_overlap(sh["index"], w) for w in windows[leaf])

    wanted = {rel for rel, (leaf, sh) in shard_of.items() if needed(leaf, sh)}
    rels = sorted(wanted if windows is not None else wanted | (
        {r for r in manifest if r.startswith("data/")} if full else set()))

    def one(rel):
        data = _read_file(path, rel, manifest.get(rel) if full else None)
        if rel not in shard_of:
            return None
        leaf, sh = shard_of[rel]
        if rel in wanted or (full and leaf in scope):
            arr = _npy_array(path, leaf, sh, data,
                             digest=full and leaf in scope)
            return arr if rel in wanted else None
        return None

    with ThreadPoolExecutor(_IO_THREADS) as pool:
        arrays = dict(zip(rels, pool.map(one, rels)))
    return index, {rel: a for rel, a in arrays.items() if rel in wanted}


def verify_checkpoint(path, integrity="full", elastic=False):
    """Integrity audit of a checkpoint directory; raises
    :class:`CheckpointCorruptError` (or FileNotFoundError) naming the
    offending file or leaf.  ``integrity``: "full" checks CRC32s and
    content digests, "size" only existence and size, "off" only the
    markers.  Returns the merged leaf index."""
    return _check(path, integrity, elastic)[0]


def _merge_index(path, procs=None):
    """Merge ``index.<proc>.json`` files into one leaf index, restricted
    to the ranks ``procs`` (the committed ones) when given."""
    merged = {}
    names = sorted(n for n in os.listdir(path)
                   if n.startswith("index.") and n.endswith(".json"))
    if procs is not None:
        want = {f"index.{p}.json" for p in procs}
        names = [n for n in names if n in want]
    if not names:
        raise FileNotFoundError(f"no index.*.json under {path}")
    for n in names:
        with open(os.path.join(path, n)) as f:
            idx = json.load(f)
        for leaf, entry in idx.items():
            if leaf in merged:
                merged[leaf]["shards"].extend(entry["shards"])
            else:
                merged[leaf] = entry
    return merged


def sweep_staging(root, max_age=3600.0, now=None):
    """Startup janitor: remove crash debris under checkpoint root
    ``root``: staging and backup directories (``*.tmp.<nonce>`` /
    ``*.old.<nonce>``) except the newest staging one (it may belong to
    a save still running), and partially committed checkpoint
    directories.  Only entries older than ``max_age`` seconds are
    touched; committed checkpoints never are.  Returns the number of
    directories removed; filesystem races are swallowed."""
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    now = time.time() if now is None else now
    staging, partial = [], []
    for n in names:
        p = os.path.join(root, n)
        if not os.path.isdir(p):
            continue
        try:
            age = now - os.path.getmtime(p)
        except OSError:
            continue
        if _STAGING_RE.search(n):
            staging.append((age, p))
        elif age > max_age and _looks_like_checkpoint(p) \
                and not is_committed(p):
            partial.append(p)
    if staging:
        # the newest in-flight nonce is spared unconditionally
        staging.sort()
        partial.extend(p for age, p in staging[1:] if age > max_age)
    for p in partial:
        logger.info("checkpoint janitor: sweeping orphaned %s", p)
        shutil.rmtree(p, ignore_errors=True)
    get_telemetry().record_staging_sweep(len(partial))
    return len(partial)


def _looks_like_checkpoint(path):
    """Only directories with checkpoint files are janitor candidates,
    never an arbitrary directory under the root."""
    try:
        names = os.listdir(path)
    except OSError:
        return False
    return any(_COMMIT_RE.match(n) or n == "data"
               or (n.startswith("index.") and n.endswith(".json"))
               for n in names)


def read_leaf(path, leaf, window=None, integrity="size", elastic=False):
    """One saved leaf (or a window of it, ``[[start, stop], ...]``) as a
    numpy array (bf16 as its int16 bit pattern), after verifying the
    checkpoint at ``integrity`` (coverage and digests only for this
    leaf)."""
    index, arrays = _check(path, integrity, elastic, leaves=(leaf,),
                           scope=(leaf,))
    reader = _LeafReader(leaf, index[leaf], arrays)
    if window is None:
        sel = tuple(slice(0, d) for d in reader.shape)
    else:
        sel = tuple(slice(int(a), int(b)) for a, b in window)
    return reader.read(sel)


def rank_payload_bytes(path, proc, prefixes=("params", "opt_tree")):
    """The element bytes of the windows rank ``proc`` wrote to the
    checkpoint at ``path`` under the top-level keys ``prefixes`` (no
    file headers): summed over the ranks of a sharded save, each leaf's
    bytes once."""
    with open(os.path.join(path, f"index.{proc}.json")) as f:
        idx = json.load(f)
    total = 0
    for leaf, entry in idx.items():
        if leaf.split(_SEP)[0] not in prefixes:
            continue
        size = np.dtype(np.int16 if entry["dtype"] == _BF16
                        else entry["dtype"]).itemsize
        for sh in entry["shards"]:
            total += size * int(np.prod([b - a for a, b in sh["index"]]))
    return total


class _LeafReader:
    """Assembles windows of one saved array from its shards' arrays
    (``arrays``: {shard file: array}, as :func:`_check` read them).
    bf16 is read as its int16 bit pattern.  With ``plan`` (a dict) set,
    a read records the window it asks for under the leaf and returns an
    empty array: :func:`load_sharded` plans which files to read that
    way, through the pipeline readers, before it reads any."""

    def __init__(self, leaf, entry, arrays, plan=None):
        self.leaf = leaf
        self.arrays = arrays
        self.entry = entry
        self.shape = tuple(entry["shape"])
        self.dtype = entry["dtype"]
        self.plan = plan

    def read(self, idx):
        """idx: tuple of slices into the global array."""
        want = [(sl.start or 0, sl.stop if sl.stop is not None else dim)
                for sl, dim in zip(idx, self.shape)]
        out_shape = tuple(b - a for a, b in want)
        bf16 = self.dtype == _BF16
        dtype = np.int16 if bf16 else np.dtype(self.dtype)
        if self.plan is not None:
            self.plan.setdefault(self.leaf, []).append(
                [list(w) for w in want])
            return np.empty(out_shape, dtype)
        shards = self.entry["shards"]
        if len(shards) == 1 and [tuple(w) for w in shards[0]["index"]] == want:
            # one shard is the whole window: its array, not a copy
            src = self.arrays["data/" + shards[0]["file"]]
            return src.view(np.uint16).view(np.int16) if bf16 else src
        out = np.empty(out_shape, dtype)
        filled = 0
        for sh in self.entry["shards"]:
            win = sh["index"]
            inter = []
            ok = True
            for (wa, wb), (sa, sb) in zip(want, win):
                a, b = max(wa, sa), min(wb, sb)
                if a >= b:
                    ok = False
                    break
                inter.append((a, b))
            if not ok and want:
                continue
            src = self.arrays["data/" + sh["file"]]
            if bf16:
                src = src.view(np.uint16).view(np.int16)
            if not want:  # 0-d
                return np.array(src)
            src_sel = tuple(slice(a - sa, b - sa)
                            for (a, b), (sa, _sb) in zip(inter, win))
            dst_sel = tuple(slice(a - wa, b - wa)
                            for (a, b), (wa, _wb) in zip(inter, want))
            out[dst_sel] = src[src_sel]
            filled += int(np.prod([b - a for a, b in inter]))
        if filled < int(np.prod(out_shape)):
            raise ValueError(
                f"checkpoint shards do not cover requested window {want}")
        return out


# -- pipeline layouts: stacked __ppstack__ leaves <-> per-block leaves --------

_PP = "__ppstack__."


def _full(idx, shape):
    """``idx`` (slices, possibly fewer than dimensions) with open ends
    closed by ``shape``."""
    idx = tuple(idx or ())
    return tuple(slice(s.start or 0, shape[d] if s.stop is None else s.stop)
                 for d, s in enumerate(idx)) + \
        tuple(slice(0, d) for d in shape[len(idx):])


class _StackedReader:
    """N per-block saved leaves presented as one ``[N, ...]`` stacked
    array (a per-block checkpoint loaded into a pp-stacked state)."""

    def __init__(self, readers):
        self.readers = readers
        self.shape = (len(readers),) + tuple(readers[0].shape)
        self.dtype = readers[0].dtype

    def read(self, idx):
        idx = _full(idx, self.shape)
        lo, hi = idx[0].start, idx[0].stop
        parts = [self.readers[i].read(idx[1:])[None] for i in range(lo, hi)]
        return np.concatenate(parts, 0)


class _RowReader:
    """Row ``i`` of a saved stacked leaf (a pp-stacked checkpoint loaded
    into a per-block state): the reference's ``pp_parallel_adaptor``
    direction."""

    def __init__(self, reader, i):
        self.reader = reader
        self.i = i
        self.shape = tuple(reader.shape[1:])
        self.dtype = reader.dtype

    def read(self, idx):
        idx = _full(idx, self.shape)
        return self.reader.read((slice(self.i, self.i + 1),) + idx)[0]


class _LeadLayoutReader:
    """A saved ``__ppstack__`` leaf under another leading layout: flat
    ``[N, ...]`` and interleaved ``[v, N/v, ...]`` are both row-major
    views of the natural block order, so only the leading indices
    change."""

    def __init__(self, reader, shape):
        self.reader = reader
        self.shape = tuple(shape)
        self.dtype = reader.dtype
        # leading dimensions on each side: 1 (flat) or 2 (interleaved)
        self._src_lead = 2 if len(reader.shape) > len(shape) else 1
        self._tgt_lead = 2 if len(shape) > len(reader.shape) else 1

    def _read_flat_rows(self, lo, hi, rest):
        r = self.reader
        if self._src_lead == 1:
            return r.read((slice(lo, hi),) + rest)
        R = r.shape[1]
        parts = []
        for g in range(lo // R, (hi - 1) // R + 1):
            r0, r1 = max(lo - g * R, 0), min(hi - g * R, R)
            parts.append(r.read((slice(g, g + 1), slice(r0, r1)) + rest)[0])
        return np.concatenate(parts, 0)

    def read(self, idx):
        idx = _full(idx, self.shape)
        if self._tgt_lead == 1:
            return self._read_flat_rows(idx[0].start, idx[0].stop, idx[1:])
        R = self.shape[1]
        r0, r1 = idx[1].start, idx[1].stop
        rows = [self._read_flat_rows(g * R + r0, g * R + r1, idx[2:])[None]
                for g in range(idx[0].start, idx[0].stop)]
        return np.concatenate(rows, 0)


def _adapt_pp_layout(readers, tmpl_flat):
    """Bridge flat and interleaved pp-stack layouts (the same blocks,
    another leading split) between the checkpoint and the template."""
    for tk, tmpl in tmpl_flat.items():
        r = readers.get(tk)
        if r is None:
            continue
        name = _unesc(tk.split(_SEP)[-1])
        tshape = _leaf_shape(tmpl)
        if (name.startswith(_PP) and tshape and tuple(r.shape) != tshape
                and int(np.prod(r.shape)) == int(np.prod(tshape))
                and abs(len(r.shape) - len(tshape)) == 1):
            readers[tk] = _LeadLayoutReader(r, tshape)
    return readers


def _leaf_shape(t):
    """A template leaf's (global) shape."""
    if isinstance(t, (ShardWindow, HostLocalShard)):
        return tuple(t.global_shape)
    return tuple(getattr(t, "shape", ()) or ())


def _block_of(name, loc):
    """The global block index of the per-block parameter ``name`` whose
    name within the block is ``loc``: the number in front of ``"." +
    loc`` (``gpt.layers.7.attn.qkv_proj.weight`` -> 7), read from the
    name, since a pipeline stage's template holds only its own blocks;
    None when ``name`` is not a block's."""
    if not name.endswith("." + loc):
        return None
    m = re.search(r"(\d+)$", name[:-len(loc) - 1])
    return None if m is None else int(m.group(1))


def _translate_pp(readers, tmpl_flat):
    """Reconcile ``__ppstack__`` stacked leaves with per-block ones
    between the checkpoint and the template, in either direction (the
    reference's pipeline re-partitioning on load,
    ``fleet/utils/pp_parallel_adaptor.py``).  A block's row in a stacked
    leaf is its global index (:func:`_block_of`)."""
    ck = set(readers)

    def parent_and_name(key):
        comps = key.split(_SEP)
        return _SEP.join(comps[:-1]), _unesc(comps[-1])

    for tk in tmpl_flat:
        if tk in ck:
            continue
        parent, name = parent_and_name(tk)
        if name.startswith(_PP):
            # the template is stacked, the checkpoint per-block
            loc = name[len(_PP):]
            blocks = {}
            for k in ck:
                par, n = parent_and_name(k)
                i = _block_of(n, loc) if par == parent and \
                    not n.startswith(_PP) else None
                if i is not None:
                    blocks[i] = k
            if blocks and sorted(blocks) == list(range(len(blocks))):
                readers[tk] = _StackedReader(
                    [readers[blocks[i]] for i in range(len(blocks))])
            continue
        # the template is per-block, the checkpoint stacked
        rank = len(_leaf_shape(tmpl_flat[tk]))
        for sk in ck:
            spar, sname = parent_and_name(sk)
            if spar != parent or not sname.startswith(_PP):
                continue
            row = _block_of(name, sname[len(_PP):])
            if row is None:
                continue
            base = readers[sk]
            if len(base.shape) == rank + 2:
                # interleaved [v, pp * Lv, ...]: viewed flat first
                base = _LeadLayoutReader(
                    base, (base.shape[0] * base.shape[1],) +
                    tuple(base.shape[2:]))
            if row < base.shape[0]:
                readers[tk] = _RowReader(base, row)
            break
    return readers


def _to_tensor(arr, dtype, device):
    t = torch.from_numpy(arr)       # the bytes read, no copy
    if dtype == _BF16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def load_sharded(path, mesh=None, shardings=None, template=None,
                 integrity="full", elastic=False, *, device=None):
    """Load a checkpoint as a nested dict of tensors, each leaf whole or
    the window of it this rank holds.

    Before any tensor is built the checkpoint is verified
    (``integrity``: "full" = CRC32, coverage and content digests,
    "size" = existence, size and coverage, "off" = COMMIT markers only);
    an uncommitted or corrupt checkpoint raises
    :class:`CheckpointCorruptError` naming the leaf or file.
    ``elastic=True`` stitches a checkpoint written at another world
    size (or with ranks lost) from the committed ranks' windows.

    ``mesh`` (:class:`.mesh.Mesh`) and ``shardings`` ({leaf key: spec})
    place each leaf as the JAX package's ``load_sharded`` does: this
    rank (``torch.distributed``'s) gets the window its mesh coordinates
    hold under ``shardings[leaf]``, else under the template leaf's spec
    (a :class:`ShardWindow` template leaf names its window itself), else
    under the saved spec adapted to ``mesh`` (``_target_spec``).  Without
    a mesh every leaf comes back whole.  Only the shard files those
    windows meet are read and verified.

    ``template``: a nested dict like the saved one; only its leaves are
    restored, each on the template leaf's device (a tensor's or a
    window's, else ``device``), in the checkpoint's dtype; a leaf the
    checkpoint lacks keeps the template's value, and empty subtrees
    stay.  A template stacked where the checkpoint is per-block (or the
    other way round, or at another number of virtual stages) is
    translated.  Without a template every saved leaf comes back, on
    ``device`` (default the CPU)."""
    opened = _open(path, integrity, elastic)
    index = opened[2]
    tmpl_flat = {} if template is None else {
        _leaf_name(p): a for p, a in _flat_items(template)}
    arrays: dict = {}
    plan: dict = {}
    base = {leaf: _LeafReader(leaf, entry, arrays, plan)
            for leaf, entry in index.items()}
    readers = dict(base)
    if template is not None:
        readers = _translate_pp(readers, tmpl_flat)
        readers = {k: r for k, r in readers.items() if k in tmpl_flat}
        readers = _adapt_pp_layout(readers, tmpl_flat)
    coords = None if mesh is None else mesh.coords(process_index())
    device = torch.device("cpu") if device is None else torch.device(device)
    sel = {}
    for leaf, reader in readers.items():
        t = tmpl_flat.get(leaf)
        if isinstance(t, ShardWindow):
            win = t.window
        elif mesh is not None and shardings and leaf in shardings:
            win = spec_window(shardings[leaf], reader.shape, mesh, coords)
        elif mesh is not None and not isinstance(t, torch.Tensor):
            saved = index[leaf]["spec"] if leaf in index else None
            win = spec_window(_target_spec(saved, reader.shape, mesh),
                              reader.shape, mesh, coords)
        else:
            win = [[0, d] for d in reader.shape]
        sel[leaf] = tuple(slice(a, b) for a, b in win)
        reader.read(sel[leaf])                 # plan: records the windows
    for r in base.values():
        r.plan = None
    _, got = _check(path, integrity, elastic, leaves=list(plan),
                    scope=list(plan), windows=plan, opened=opened)
    arrays.update(got)
    flat_out = {}
    for leaf, reader in readers.items():
        arr = reader.read(sel[leaf])
        t = tmpl_flat.get(leaf)
        if isinstance(t, ShardWindow):
            dev = t.device
        else:
            dev = t.device if isinstance(t, torch.Tensor) else device
        flat_out[leaf] = _to_tensor(np.require(arr, requirements="C"),
                                    reader.dtype, dev)
    if template is None:
        return _unflatten(flat_out)

    def rebuild(node, path=()):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
        return flat_out.get(_leaf_name(path), node)

    return rebuild(template)


# -- whole-state convenience ---------------------------------------------------

def save_state(state, path):
    """Save a training state (a nested dict of tensors) to ``path``."""
    save_sharded(state, path)


def load_state(path, state, integrity="full"):
    """Copy the checkpoint at ``path`` into ``state``'s live tensors in
    place (never rebinding one: a captured graph and the kernels' TMA
    maps read them where they are).  Every tensor leaf of ``state`` must
    be in the checkpoint with its shape and dtype; raises ``KeyError``
    or ``ValueError`` naming the leaf otherwise.  Returns ``state``."""
    loaded = load_sharded(path, template=state, integrity=integrity)
    copy_into(state, loaded)
    return state


def copy_into(state, loaded) -> None:
    """Copy each tensor leaf of ``loaded`` into the same leaf of
    ``state`` in place (a :class:`ShardWindow` leaf into its parts).  A leaf of ``state`` that ``loaded`` lacks, or
    holds as the very same object (a template leaf the checkpoint
    lacked), raises ``KeyError``; a shape or dtype that differs raises
    ``ValueError``."""
    got = dict(_flat_items(loaded))
    pairs = []
    for p, dst in _flat_items(state):
        if isinstance(dst, ShardWindow):
            src = got.get(p)
            if not isinstance(src, torch.Tensor):
                raise KeyError(f"the checkpoint has no leaf {'/'.join(p)!r}")
            pairs.append((dst, src))
            continue
        if not isinstance(dst, torch.Tensor):
            continue
        src = got.get(p)
        if src is None or src is dst:
            raise KeyError(f"the checkpoint has no leaf {'/'.join(p)!r}")
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(
                f"leaf {'/'.join(p)!r}: checkpoint {src.dtype} "
                f"{tuple(src.shape)}, live {dst.dtype} {tuple(dst.shape)}")
        pairs.append((dst, src))
    with torch.no_grad():
        for dst, src in pairs:
            if isinstance(dst, ShardWindow):
                dst.assign(src)
            else:
                dst.copy_(src)
