"""The shard writer and reader (the JAX package's `datastore/store.py`).

`ShardWriter` takes row-major binned blocks (the orientation of the
in-memory bin matrix and of the two_round reader's chunks), gathers them
into shards of exactly `shard_rows` rows and writes each shard
feature-major ([F, rows] C-order), the orientation of the device matrix,
so that assembly copies a shard into its column slice without a
transpose on the host.

`ShardStore` opens a finalized directory, validates the manifest and
serves shards as numpy memory maps, each shard's crc32 checked on its
first load.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import format as _fmt
from ..utils.log import LightGBMError

#: the blocks the prefetch pipeline holds beyond its queue: one in the
#: reader's hands while the queue is full, one being copied to the device
PIPELINE_SLACK_BLOCKS = 2

_VEC_DTYPES = {"label": np.float32, "weight": np.float32}


def auto_shard_rows(n_rows: int, row_bytes: int, budget_mb: float,
                    prefetch_depth: int) -> int:
    """Rows a shard such that the prefetch pipeline's resident blocks
    (depth + 2 of them) stay inside `budget_mb` of host memory; at least
    256, at most `n_rows`."""
    blocks = max(1, int(prefetch_depth)) + PIPELINE_SLACK_BLOCKS
    budget = max(float(budget_mb), 0.0625) * (1 << 20)
    target = int(budget // (blocks * max(int(row_bytes), 1)))
    return int(min(max(256, target), max(n_rows, 1)))


def _check_blocks(payloads, n_features: int, dtype, bins, bundle, label,
                  weight, what: str) -> Dict[str, np.ndarray]:
    """The payloads of one row-major block, checked for shape and cast."""
    blocks = {"bins": np.asarray(bins, dtype=dtype)}
    rows = blocks["bins"].shape[0]
    if blocks["bins"].ndim != 2 or blocks["bins"].shape[1] != n_features:
        raise LightGBMError(
            f"datastore {what}: bins block {blocks['bins'].shape} does not "
            f"match n_features={n_features}")
    for name, arr in (("bundle", bundle), ("label", label),
                      ("weight", weight)):
        if name in payloads:
            if arr is None or len(arr) != rows:
                raise LightGBMError(
                    f"datastore {what}: payload '{name}' missing or "
                    f"misaligned ({None if arr is None else len(arr)} vs "
                    f"{rows} rows)")
            blocks[name] = np.asarray(arr, dtype=_VEC_DTYPES.get(name, dtype))
    return blocks


def _write_shard(dirpath: str, index: int, row0: int,
                 blocks: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Write one shard's payload files (matrices feature-major) and return
    its manifest entry."""
    rows = len(blocks["bins"])
    entry: Dict[str, Any] = {"row0": row0, "rows": rows, "files": {}}
    for payload, block in blocks.items():
        if payload in ("bins", "bundle"):
            block = block.T
        raw = np.ascontiguousarray(block).tobytes()
        with open(os.path.join(dirpath, _fmt.shard_filename(index, payload)),
                  "wb") as fh:
            fh.write(raw)
        entry["files"][payload] = {"crc32": _fmt.crc32_bytes(raw),
                                   "nbytes": len(raw)}
    return entry


class ShardWriter:
    """Row-major binned blocks into fixed-size shards on disk."""

    def __init__(self, dirpath: str, n_features: int, dtype,
                 shard_rows: int, bundle_cols: int = 0,
                 has_label: bool = False, has_weight: bool = False,
                 meta: Optional[Dict[str, Any]] = None):
        os.makedirs(dirpath, exist_ok=True)
        if os.path.exists(os.path.join(dirpath, _fmt.MANIFEST_NAME)):
            raise LightGBMError(
                f"datastore directory already holds a manifest: {dirpath} "
                "(each spilled Dataset needs its own directory)")
        self.dirpath = dirpath
        self.n_features = int(n_features)
        self.dtype = np.dtype(dtype)
        self.shard_rows = int(shard_rows)
        if self.shard_rows < 1:
            raise LightGBMError(f"datastore_shard_rows must be >= 1, got "
                                f"{shard_rows}")
        self.bundle_cols = int(bundle_cols)
        self.meta = dict(meta or {})
        self.payloads: Tuple[str, ...] = tuple(
            p for p, on in (("bins", True), ("bundle", bundle_cols > 0),
                            ("label", has_label), ("weight", has_weight))
            if on)
        self._pending: Dict[str, List[np.ndarray]] = \
            {p: [] for p in self.payloads}
        self._pending_rows = 0
        self._shards: List[Dict[str, Any]] = []
        self._row0 = 0
        self._finalized = False

    def append(self, bins: np.ndarray, bundle: Optional[np.ndarray] = None,
               label: Optional[np.ndarray] = None,
               weight: Optional[np.ndarray] = None) -> None:
        """Queue a row-major block; full shards are written as they fill,
        so at most a shard's rows wait in memory."""
        assert not self._finalized
        blocks = _check_blocks(self.payloads, self.n_features, self.dtype,
                               bins, bundle, label, weight, "append")
        for name, arr in blocks.items():
            self._pending[name].append(arr)
        self._pending_rows += len(blocks["bins"])
        while self._pending_rows >= self.shard_rows:
            self._flush(self.shard_rows)

    def _take(self, payload: str, rows: int) -> np.ndarray:
        """The first `rows` rows of a payload's queue, taken off it."""
        out, got = [], 0
        pend = self._pending[payload]
        while got < rows:
            head = pend[0]
            take = min(rows - got, len(head))
            out.append(head[:take])
            got += take
            if take == len(head):
                pend.pop(0)
            else:
                pend[0] = head[take:]
        return np.concatenate(out) if len(out) > 1 else out[0]

    def _flush(self, rows: int) -> None:
        blocks = {p: self._take(p, rows) for p in self.payloads}
        self._shards.append(_write_shard(self.dirpath, len(self._shards),
                                         self._row0, blocks))
        self._row0 += rows
        self._pending_rows -= rows

    def finalize(self) -> "ShardStore":
        """Write the tail shard and the checksummed manifest; open the
        finished store."""
        assert not self._finalized
        if self._pending_rows:
            self._flush(self._pending_rows)
        self._finalized = True
        _fmt.write_manifest(self.dirpath, {
            "dtype": self.dtype.name, "n_rows": self._row0,
            "n_features": self.n_features, "bundle_cols": self.bundle_cols,
            "shard_rows": self.shard_rows, "payloads": list(self.payloads),
            "shards": self._shards, "meta": self.meta})
        return ShardStore.open(self.dirpath)


class ShardStore:
    """The read side: a validated manifest, memory-mapped shards."""

    def __init__(self, dirpath: str, manifest: Dict[str, Any]):
        self.dirpath = dirpath
        self.manifest = manifest
        self.dtype = np.dtype(manifest["dtype"])
        self.n_rows = int(manifest["n_rows"])
        self.n_features = int(manifest["n_features"])
        self.bundle_cols = int(manifest.get("bundle_cols", 0))
        self.shard_rows = int(manifest["shard_rows"])
        #: bumped by each `append_rows` rewrite of the manifest
        self.generation = int(manifest.get("generation", 0))
        self.payloads: Tuple[str, ...] = tuple(manifest["payloads"])
        self.shards: List[Dict[str, Any]] = manifest["shards"]
        self.meta: Dict[str, Any] = manifest.get("meta", {})
        self._verified: set = set()

    @classmethod
    def open(cls, dirpath: str) -> "ShardStore":
        return cls(dirpath, _fmt.read_manifest(dirpath))

    # ---- sizes
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def rows_of(self, k: int) -> int:
        return int(self.shards[k]["rows"])

    def row0_of(self, k: int) -> int:
        return int(self.shards[k]["row0"])

    def payload_cols(self, payload: str) -> int:
        return self.bundle_cols if payload == "bundle" else self.n_features

    def shard_nbytes(self, k: int, payload: str) -> int:
        return int(self.shards[k]["files"][payload]["nbytes"])

    def total_bytes(self, payload: Optional[str] = None) -> int:
        names = [payload] if payload else list(self.payloads)
        return sum(int(s["files"][p]["nbytes"])
                   for s in self.shards for p in names)

    # ---- growing
    def append_rows(self, bins: np.ndarray,
                    bundle: Optional[np.ndarray] = None,
                    label: Optional[np.ndarray] = None,
                    weight: Optional[np.ndarray] = None) -> int:
        """Grow the store by a row-major block: new tail shards, each
        file with its own crc32 and byte count, then the manifest
        rewritten atomically with `generation` bumped (a reader sees the
        whole old generation or the whole new one).  Existing shard files
        are never touched.  Returns the new generation."""
        blocks = _check_blocks(self.payloads, self.n_features, self.dtype,
                               bins, bundle, label, weight, "append_rows")
        rows = len(blocks["bins"])
        if rows == 0:
            raise LightGBMError("datastore append_rows: empty block")
        new_entries: List[Dict[str, Any]] = []
        for pos in range(0, rows, self.shard_rows):
            take = min(self.shard_rows, rows - pos)
            new_entries.append(_write_shard(
                self.dirpath, len(self.shards) + len(new_entries),
                self.n_rows + pos,
                {p: b[pos:pos + take] for p, b in blocks.items()}))
        manifest = dict(self.manifest)
        manifest["shards"] = list(self.shards) + new_entries
        manifest["n_rows"] = self.n_rows + rows
        manifest["generation"] = self.generation + 1
        _fmt.write_manifest(self.dirpath, manifest)
        # re-read through the validator: this handle sees what any new
        # reader sees
        fresh = _fmt.read_manifest(self.dirpath)
        self.manifest = fresh
        self.n_rows = int(fresh["n_rows"])
        self.generation = int(fresh["generation"])
        self.shards = fresh["shards"]
        return self.generation

    # ---- reading
    def load_shard(self, k: int, payload: str = "bins") -> np.ndarray:
        """One shard's payload as a memory map: [F|G, rows] for the
        matrices, [rows] for label and weight.  Its crc32 is checked on
        the shard's first load."""
        path = os.path.join(self.dirpath, _fmt.shard_filename(k, payload))
        try:
            mm = np.memmap(path, mode="r", dtype=np.uint8)
        except (OSError, ValueError) as e:
            raise LightGBMError(f"datastore shard unreadable: {path} ({e})")
        if (k, payload) not in self._verified:
            _fmt.verify_payload(self.dirpath, k, payload,
                                self.shards[k]["files"][payload],
                                memoryview(mm))
            self._verified.add((k, payload))
        rows = self.rows_of(k)
        if payload in ("bins", "bundle"):
            return mm.view(self.dtype).reshape(self.payload_cols(payload),
                                               rows)
        return mm.view(_VEC_DTYPES[payload]).reshape(rows)

    def load_vector(self, payload: str) -> np.ndarray:
        """The [N] label or weight over all shards."""
        return np.concatenate([np.asarray(self.load_shard(k, payload))
                               for k in range(self.n_shards)])

    def read_all_rows(self, payload: str = "bins") -> np.ndarray:
        """The whole row-major matrix on the host, for the paths that need
        it at once (DART's replays, `add_features_from`)."""
        out = np.empty((self.n_rows, self.payload_cols(payload)),
                       dtype=self.dtype)
        for k in range(self.n_shards):
            r0 = self.row0_of(k)
            out[r0:r0 + self.rows_of(k)] = self.load_shard(k, payload).T
        return out

    # ---- subsets
    def plan_rows(self, indices: np.ndarray) \
            -> Tuple[List[Tuple[int, np.ndarray]], int, int]:
        """Sorted global row indices by shard: (plan, bytes_saved,
        shards_skipped).  The plan holds (shard, shard-relative indices)
        for the shards with a selected row; bytes_saved counts the matrix
        bytes of the rows not selected, whole skipped shards and the rest
        of partly selected ones."""
        idx = np.asarray(indices, dtype=np.int64)
        plan: List[Tuple[int, np.ndarray]] = []
        saved = skipped = 0
        mat = [p for p in self.payloads if p in ("bins", "bundle")]
        for k in range(self.n_shards):
            r0, rows = self.row0_of(k), self.rows_of(k)
            lo, hi = np.searchsorted(idx, [r0, r0 + rows])
            sel = hi - lo
            row_nbytes = sum(self.shard_nbytes(k, p) for p in mat) // rows
            if sel == 0:
                skipped += 1
                saved += rows * row_nbytes
                continue
            plan.append((k, idx[lo:hi] - r0))
            saved += (rows - sel) * row_nbytes
        return plan, saved, skipped

    def gather_rows(self, indices: np.ndarray, payload: str = "bins") \
            -> Tuple[np.ndarray, int, int]:
        """The rows of a sorted global index set, row-major [len, F|G],
        read from the shards that hold them only: (rows, bytes_saved,
        shards_skipped)."""
        plan, saved, skipped = self.plan_rows(indices)
        out = np.empty((len(np.asarray(indices)),
                        self.payload_cols(payload)), dtype=self.dtype)
        pos = 0
        for k, rel in plan:
            out[pos:pos + len(rel)] = self.load_shard(k, payload)[:, rel].T
            pos += len(rel)
        return out, saved, skipped
