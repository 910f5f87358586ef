"""Record pipeline: the ctypes binding of the C++ loader and its Python
engine. The port's own copy of ``tf_operator_tpu/native/pipeline.py``,
with the same names, semantics and error contract; it logs through the
standard ``logging`` module.

``RecordPipeline`` streams batches of fixed-size records from a binary file
with per-epoch shuffling and multi-threaded prefetch. The native engine
(record_pipeline.cc) does the IO and shuffling off the GIL; the pure-Python
engine implements identical semantics (same splitmix64 shuffle, same batch
order) for environments without a toolchain — engines are interchangeable
and the tests assert batch-for-batch equivalence, with each other and with
the JAX package's.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
import queue as queue_mod
from typing import Iterator

import numpy as np

from tf_operator_tpu_torch.native import NativeBuildError, load_library

LOG = logging.getLogger(__name__)

_MASK = (1 << 64) - 1


def _splitmix64_stream(seed: int) -> Iterator[int]:
    s = (seed ^ 0x9E3779B97F4A7C15) & _MASK
    while True:
        s = (s + 0x9E3779B97F4A7C15) & _MASK
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        yield (z ^ (z >> 31)) & _MASK


def epoch_order(num_records: int, seed: int, epoch: int,
                shuffle: bool, shard_id: int = 0,
                num_shards: int = 1, engine: str = "auto") -> np.ndarray:
    """The record order for one epoch — shared by both engines. With
    sharding, every shard computes the SAME global order and takes its
    strided slice TRUNCATED to the common floor(n / num_shards) length:
    shards are disjoint and all exactly the same size (lockstep hosts see
    the same batch count and sizes — the multi-process shard_batch
    contract); the <num_shards remainder records of an epoch are dropped
    and re-dealt by the next epoch's shuffle, so nothing is systematically
    lost.

    engine="auto" runs the shuffle in C (dp_epoch_order; the interpreter's
    Fisher-Yates loop is ~1000x slower at million-record scale), falling
    back to Python. engine="python" is the bit-identical oracle the native
    tests compare against."""
    if engine == "auto":
        native = _native_epoch_order(
            num_records, seed, epoch, shuffle, shard_id, num_shards
        )
        if native is not None:
            return native
    order = np.arange(num_records, dtype=np.uint64)
    if shuffle and num_records > 1:
        rng = _splitmix64_stream(seed * 1000003 + epoch)
        for i in range(num_records - 1, 0, -1):
            j = next(rng) % (i + 1)
            order[i], order[j] = order[j], order[i]
    if num_shards > 1:
        order = order[shard_id::num_shards][: num_records // num_shards]
    return order


def _native_epoch_order(num_records: int, seed: int, epoch: int,
                        shuffle: bool, shard_id: int,
                        num_shards: int) -> np.ndarray | None:
    try:
        lib = load_library("record_pipeline.cc")
    except NativeBuildError:
        return None
    if not hasattr(lib, "dp_epoch_order"):
        return None
    lib.dp_epoch_order.restype = ctypes.c_int64
    lib.dp_epoch_order.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
    ]
    keep = num_records // num_shards if num_shards > 1 else num_records
    out = np.empty(keep, dtype=np.uint64)
    n = lib.dp_epoch_order(
        num_records, seed, epoch, int(shuffle), shard_id, num_shards,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), keep,
    )
    if n < 0 or n != keep:
        return None
    return out


class _NativeEngine:
    def __init__(self, path: str, record_bytes: int, batch: int,
                 prefetch: int, threads: int, seed: int,
                 shuffle: bool, loop: bool, shard_id: int,
                 num_shards: int) -> None:
        lib = load_library("record_pipeline.cc")
        lib.dp_open.restype = ctypes.c_void_p
        lib.dp_open.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
        ]
        lib.dp_next.restype = ctypes.c_int64
        lib.dp_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.dp_close.argtypes = [ctypes.c_void_p]
        lib.dp_num_records.restype = ctypes.c_uint64
        lib.dp_num_records.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._record_bytes = record_bytes
        self._batch = batch
        self._handle = lib.dp_open(
            path.encode(), record_bytes, batch, prefetch, threads, seed,
            int(shuffle), int(loop), shard_id, num_shards,
        )
        if not self._handle:
            raise NativeBuildError(f"dp_open failed for {path}")
        self.num_records = int(lib.dp_num_records(self._handle))

    def next(self) -> np.ndarray | None:
        # dp_next writes straight into the returned array's memory — no
        # intermediate ctypes buffer, so no extra copy of a batch.
        out = np.empty((self._batch, self._record_bytes), np.uint8)
        n = self._lib.dp_next(
            self._handle, out.ctypes.data_as(ctypes.c_char_p), out.nbytes
        )
        if n == 0:
            return None
        if n < 0:
            raise IOError("native record pipeline read error")
        return out if n == self._batch else out[:n]

    def close(self) -> None:
        if self._handle:
            self._lib.dp_close(self._handle)
            self._handle = None


class _PythonEngine:
    """Same semantics, implemented with reader threads + a bounded queue."""

    def __init__(self, path: str, record_bytes: int, batch: int,
                 prefetch: int, threads: int, seed: int,
                 shuffle: bool, loop: bool, shard_id: int,
                 num_shards: int) -> None:
        size = os.path.getsize(path)
        if size == 0 or size % record_bytes:
            raise ValueError(f"{path}: size {size} not a multiple of record")
        self.num_records = size // record_bytes
        # Empty-shard validation lives in RecordPipeline.__init__ (shared
        # by both engines).
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce,
            args=(path, record_bytes, batch, seed, shuffle, loop,
                  shard_id, num_shards),
            daemon=True,
        )
        self._thread.start()

    def _produce(self, path, record_bytes, batch, seed, shuffle, loop,
                 shard_id, num_shards):
        try:
            epoch = 0
            with open(path, "rb") as f:
                while not self._stop.is_set():
                    order = epoch_order(self.num_records, seed, epoch,
                                        shuffle, shard_id, num_shards)
                    for lo in range(0, len(order), batch):
                        recs = order[lo: lo + batch]
                        out = np.empty((len(recs), record_bytes), np.uint8)
                        for i, r in enumerate(recs):
                            f.seek(int(r) * record_bytes)
                            out[i] = np.frombuffer(
                                f.read(record_bytes), np.uint8
                            )
                        if not self._put(out):
                            return
                    if not loop:
                        self._put(None)
                        return
                    epoch += 1
        except Exception as exc:  # noqa: BLE001 — surfaced to the consumer
            # Mirror the native engine's error contract (dp_next -> -1):
            # a producer fault must raise in next(), never hang it.
            self._put(exc)

    def _put(self, item) -> bool:
        """Bounded put that honors stop; False when stopping."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def next(self) -> np.ndarray | None:
        item = self._q.get()
        if isinstance(item, Exception):
            raise IOError("record pipeline producer failed") from item
        return item

    def close(self) -> None:
        self._stop.set()
        # Sentinel for a reader concurrently blocked in next()'s get(): the
        # producer exits via _put returning False without putting anything,
        # so without this a reader thread would hang forever. Drain-then-put
        # must loop: a producer blocked in _put can deposit one more real
        # item right after a drain pass (refilling a size-1 queue), in which
        # case the first put_nowait raises Full and must be retried — the
        # producer stops refilling once it observes _stop, so this converges.
        while True:
            try:
                while True:
                    self._q.get_nowait()
            except queue_mod.Empty:
                pass
            try:
                self._q.put_nowait(None)
                return
            except queue_mod.Full:
                continue


class RecordPipeline:
    """Batched, shuffled, prefetching reader over fixed-size records.

    engine: "native" (C++), "python", or "auto" (native with fallback).
    Iterating yields [n, record_bytes] uint8 arrays (the final batch of an
    epoch may be short); callers reinterpret via .view(dtype).reshape(...).

    shard_id/num_shards: multi-host input — every shard computes the same
    per-epoch order and consumes its strided slice, so shards are disjoint
    and jointly exhaustive within each epoch (the per-host-input contract
    of shard_batch's multi-process path).
    """

    def __init__(self, path: str, record_bytes: int, batch: int, *,
                 prefetch: int = 4, threads: int = 2, seed: int = 0,
                 shuffle: bool = True, loop: bool = False,
                 engine: str = "auto", shard_id: int = 0,
                 num_shards: int = 1) -> None:
        if num_shards < 1 or not 0 <= shard_id < num_shards:
            raise ValueError(f"bad shard {shard_id}/{num_shards}")
        # Data-configuration errors surface HERE, not as a fake
        # native-build failure from dp_open returning null.
        total = os.path.getsize(path) // record_bytes if os.path.exists(path) else 0
        if total and total // num_shards == 0:
            raise ValueError(
                f"shard {shard_id}/{num_shards} is empty: only {total} "
                f"records (equal-size shards get n // num_shards each)"
            )
        args = (path, record_bytes, batch, prefetch, threads, seed, shuffle,
                loop, shard_id, num_shards)
        if engine == "native":
            self._engine = _NativeEngine(*args)
        elif engine == "python":
            self._engine = _PythonEngine(*args)
        elif engine == "auto":
            try:
                self._engine = _NativeEngine(*args)
            except NativeBuildError as e:
                LOG.warning("native pipeline unavailable (%s); python engine", e)
                self._engine = _PythonEngine(*args)
        else:
            raise ValueError(f"unknown engine {engine!r}")
        self.engine_name = type(self._engine).__name__.strip("_")

    @property
    def num_records(self) -> int:
        return self._engine.num_records

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            out = self._engine.next()
            if out is None:
                return
            yield out

    def close(self) -> None:
        self._engine.close()

    def __enter__(self) -> "RecordPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_records(path: str, array: np.ndarray) -> None:
    """Write an [n, ...] array as n fixed-size records (row-major bytes)."""
    arr = np.ascontiguousarray(array)
    with open(path, "wb") as f:
        f.write(arr.tobytes())


class MMapRecordPipeline:
    """Zero-copy record access for page-cache-resident files: the file is
    mmap'd once and batches are INDEX arrays (epoch_order slices), consumed
    by ``augment.augment_gather`` which crops straight out of the mapping —
    the only host byte movement per image is the crop write itself
    (chip_smoke.py's phase 23 (a) times both loaders on the card's host).

    Same epoch/shuffle/shard semantics as RecordPipeline (both ride
    epoch_order), so swapping pipelines never changes the sample stream.
    Use RecordPipeline when records must be materialized as arrays (cold
    storage, transforms that need contiguous batches); use this when the
    consumer can gather (augment_gather / fancy indexing).
    """

    def __init__(self, path: str, record_bytes: int, batch: int, *,
                 seed: int = 0, shuffle: bool = True, loop: bool = False,
                 shard_id: int = 0, num_shards: int = 1) -> None:
        if num_shards < 1 or not 0 <= shard_id < num_shards:
            raise ValueError(f"bad shard {shard_id}/{num_shards}")
        size = os.path.getsize(path)
        if size == 0 or size % record_bytes:
            raise ValueError(
                f"{path}: size {size} not a multiple of record_bytes "
                f"{record_bytes}"
            )
        self.data = np.memmap(path, np.uint8, mode="r")
        self.record_bytes = record_bytes
        self.num_records = size // record_bytes
        if self.num_records // num_shards == 0:
            raise ValueError(
                f"shard {shard_id}/{num_shards} is empty: only "
                f"{self.num_records} records"
            )
        self._batch = batch
        self._seed = seed
        self._shuffle = shuffle
        self._loop = loop
        self._shard = (shard_id, num_shards)
        self._epoch = 0
        self._pos = 0
        self._order = epoch_order(
            self.num_records, seed, 0, shuffle, shard_id, num_shards
        )

    def next_indices(self) -> np.ndarray | None:
        """Record indices of the next batch (may be short at epoch end;
        None at EOF when loop=False)."""
        if self._pos >= len(self._order):
            if not self._loop:
                return None
            self._epoch += 1
            self._order = epoch_order(
                self.num_records, self._seed, self._epoch, self._shuffle,
                *self._shard,
            )
            self._pos = 0
        idx = self._order[self._pos:self._pos + self._batch]
        self._pos += len(idx)
        return idx

    def labels(self, indices: np.ndarray, offset: int = -1) -> np.ndarray:
        """Gather one metadata byte per record (default: the trailing label
        byte) as int32."""
        table = np.asarray(self.data).reshape(
            self.num_records, self.record_bytes
        )
        return table[indices, offset].astype(np.int32)

    def close(self) -> None:
        # np.memmap holds the mapping until garbage-collected; explicit
        # close for symmetry with RecordPipeline.
        self.data = None
