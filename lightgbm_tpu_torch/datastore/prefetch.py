"""A bounded read-ahead of shards (the JAX package's
`datastore/prefetch.py`).

A thread reads shard k + 1 from disk (memory map, crc32, a copy out of
the page cache) while the consumer copies shard k to the device.  The
queue holds at most `depth` blocks, so the host holds at most depth + 2
blocks (one in the reader's hands while the queue is full, one in the
consumer's); `store.auto_shard_rows` sizes shards from that bound.

`on_hit` / `on_stall` count the blocks: a hit when the block was waiting
as the consumer asked for it, a stall when the consumer had to wait for
the disk.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..resilience import FAULTS
from ..utils.locks import make_lock
from ..utils.log import LightGBMError

_DONE = object()


class PrefetchRunStats:
    """The prefetch accounting of a whole training run, across the
    prefetchers it makes (bins and bundle assembly): hit and stall
    totals (wire `hit` / `stall` as a prefetcher's callbacks), the
    passes over the store, and the largest host residency of any of
    them (`absorb`)."""

    __slots__ = ("hits", "stalls", "passes", "peak_resident_bytes",
                 "_on_hit", "_on_stall")

    def __init__(self, on_hit: Optional[Callable[[], None]] = None,
                 on_stall: Optional[Callable[[], None]] = None):
        self.hits = 0
        self.stalls = 0
        self.passes = 0
        self.peak_resident_bytes = 0
        self._on_hit = on_hit or (lambda: None)
        self._on_stall = on_stall or (lambda: None)

    def hit(self) -> None:
        self.hits += 1
        self._on_hit()

    def stall(self) -> None:
        self.stalls += 1
        self._on_stall()

    def start_pass(self) -> None:
        self.passes += 1

    def absorb(self, pf: "ShardPrefetcher") -> None:
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       pf.peak_resident_bytes)


class ShardPrefetcher:
    """(shard, row0, block) in plan order, read `depth` blocks ahead on a
    thread; a read error (a checksum, an injected `prefetch.read` fault)
    raises on the consumer's side."""

    def __init__(self, store, payload: str = "bins", depth: int = 2,
                 plan: Optional[List[Tuple[int, np.ndarray]]] = None,
                 on_hit: Optional[Callable[[], None]] = None,
                 on_stall: Optional[Callable[[], None]] = None):
        self.store = store
        self.payload = payload
        self.depth = max(1, int(depth))
        #: (shard, shard-relative row selection or None) in read order
        self.plan: List[Tuple[int, Optional[np.ndarray]]] = (
            [(k, None) for k in range(store.n_shards)]
            if plan is None else list(plan))
        self._on_hit = on_hit or (lambda: None)
        self._on_stall = on_stall or (lambda: None)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        # written by the reader thread only, read after the sentinel
        self._err: Optional[BaseException] = None
        self._resident = 0            # guarded-by: _lock
        self.peak_resident_bytes = 0  # guarded-by: _lock
        self._lock = make_lock("datastore.prefetch._lock")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="lgbt-datastore-prefetch")
        self._thread.start()

    def _track(self, delta: int) -> None:
        with self._lock:
            self._resident += delta
            self.peak_resident_bytes = max(self.peak_resident_bytes,
                                           self._resident)

    def _produce(self) -> None:
        try:
            for k, rel in self.plan:
                if self._stop.is_set():
                    return
                FAULTS.inject("prefetch.read")
                block = self.store.load_shard(k, self.payload)
                if rel is not None:
                    block = block[:, rel]
                # copied out of the memory map: the residency counted is
                # host memory the budget bounds, not page-cache views
                block = np.array(block, order="C")
                self._track(block.nbytes)
                self._q.put((k, self.store.row0_of(k), block))
        except BaseException as e:  # raised on the consumer's side
            self._err = e
        while not self._stop.is_set():   # the sentinel always lands
            try:
                self._q.put(_DONE, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        try:
            while True:
                was_empty = self._q.empty()
                item = self._q.get()
                if item is _DONE:
                    break
                (self._on_stall if was_empty else self._on_hit)()
                k, row0, block = item
                yield k, row0, block
                self._track(-block.nbytes)
        finally:
            self.close()
        if self._err is not None:
            if isinstance(self._err, LightGBMError):
                raise self._err
            raise LightGBMError(f"datastore prefetch failed: "
                                f"{self._err!r}") from self._err

    def close(self) -> None:
        """Stop the reader and drain the queue (idempotent)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
