"""Serving runtime: the compiled tile plan on the GPU, exact sums.

The port's counterpart of `lightgbm_tpu/serving/runtime.py`, reduced to
its top rung.  `ServingRuntime(booster)` exports the model, compiles it
into depth-bucketed tree tiles (`compiler.build_plan`), puts the packed
planes on the device and holds the compiled path to an exact parity
probe.  At `refresh` it also derives the forest's records from the
planes (`compiler/records.py`: one 16-byte record a node, the trees in
boosting order).  `predict` pads each request to a power-of-two row
bucket, stages it as f32 and runs `compiler.kernel.compiled_predict`
on the records: one launch of the fused serving kernel (every depth
bucket's traversal and the boosting-order f64 sum), then the
objective's link on the card.  Raw scores are byte-identical to the
JAX package's compiled rung on the same model.

What this runtime does not have yet (see ROADMAP.md): the lower rungs
of the fallback ladder (device-sum, slot path, host walk), the bounded
tier, breakers, supervisors, the watchdog, fault injection, memory-
ledger registration, `demote`, `stale` and the sharded runtime.  So it
never degrades: a model the compiled path cannot serve (linear trees,
random-forest averaging, a plan outside the packed format) and a failed
parity probe raise `LightGBMError` with the reason.

Rows are independent in the traversal and in the accumulation, so a
padded batch's real rows are bitwise equal to the unpadded batch's.
Features are cast to f32 on the way in (huge f64 values saturate to
+-inf), and thresholds are f32, as in the JAX package: a row within f32
epsilon of a split threshold may route differently from the f64 host
walk of `Booster.predict`.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compiler import PlanNotCompilable, build_plan
from ..compiler.kernel import (ROW_BLOCK, DeviceRecords, compiled_predict,
                               device_planes)
from ..compiler.records import build_records
from ..ops.predict import predict_leaf_ensemble
from ..utils.log import LightGBMError

#: padding cap: requests above it are chunked, so every device shape is
#: one of log2(4096)+1 = 13 row buckets
DEFAULT_MAX_BATCH_ROWS = 4096

#: per-tile plane budget (`tile_vmem_kb`).  The JAX package's 512 KB is
#: a TPU VMEM figure, above the 227 KB of shared memory an H100 block can
#: use.  Routing bytes do not depend on the tiling; the tile count sets
#: how many blocks the standalone traverse launch has (the fused kernel
#: walks the records, which do not depend on the tiling).  48 KB keeps a
#: tile within the shared memory any block gets without opting in, and
#: it cuts a large model into enough tiles to spread a batch over the
#: card's SMs.
DEFAULT_TILE_KB = 48.0


def bucket_rows(n: int, max_rows: int = DEFAULT_MAX_BATCH_ROWS) -> int:
    """Smallest power of two >= n, clamped to [1, max_rows]."""
    if n <= 1:
        return 1
    return min(1 << int(n - 1).bit_length(), max_rows)


def _resolve_device(device) -> torch.device:
    """`None` means the GPU.  Without one, only an explicit "cpu" runs
    (the plain versions, for tests); nothing moves to the CPU by
    itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise LightGBMError(
                "no CUDA device: ServingRuntime serves on the GPU "
                "(pass device='cpu' to run the plain versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise LightGBMError(f"unsupported device {dev}")
    return dev


class _ServeState:
    """Everything `predict` reads, published as one reference, so a
    request never mixes an old plan with a new export."""

    __slots__ = ("export", "plan", "planes", "meta", "gidx", "cls",
                 "records")

    def __init__(self, export: Dict, plan, planes: Tuple,
                 meta: Tuple, gidx: torch.Tensor,
                 cls: Optional[torch.Tensor], records: DeviceRecords):
        self.export = export
        self.plan = plan
        self.planes = planes
        self.meta = meta
        self.gidx = gidx
        self.cls = cls
        self.records = records


class ServingRuntime:
    """Serves one model through the compiled tile plan on `device`
    (default: the GPU).

    Thread-safe: `predict` reads the published state once per call, and
    `refresh` builds a complete replacement and publishes it in one
    assignment.  `tile_vmem_kb` is the planner's per-tile byte budget
    (the name is the JAX package's)."""

    def __init__(self, booster, *,
                 max_batch_rows: int = DEFAULT_MAX_BATCH_ROWS,
                 start_iteration: int = 0,
                 num_iteration: Optional[int] = None,
                 tile_vmem_kb: float = DEFAULT_TILE_KB,
                 device=None):
        self._booster = booster
        self.max_batch_rows = max(int(max_batch_rows), 1)
        self._start = start_iteration
        self._num = num_iteration
        self._tile_vmem_kb = float(tile_vmem_kb)
        self.device = _resolve_device(device)
        self._refresh_lock = threading.Lock()
        self._state: Optional[_ServeState] = None
        self.refresh()

    # ------------------------------------------------------------ export
    def refresh(self) -> None:
        """(Re-)export the booster, compile it, put the planes and the
        records on the device and run the parity probe.  Raises `LightGBMError` when
        the model cannot be served this way or the probe disagrees."""
        with self._refresh_lock:
            ex = self._booster.export_predict_arrays(
                self._start, self._num, device=self.device)
            if not ex["trees"]:
                raise LightGBMError("the model has no trees to serve")
            if ex["stacked"] is None:
                raise LightGBMError(
                    "linear trees are not served by the compiled path "
                    "(the host walk rung is not ported yet)")
            if ex["average_factor"] != 1:
                raise LightGBMError(
                    "random-forest averaging (average_output) is not "
                    "served by the compiled path")
            try:
                plan = build_plan(ex, tile_vmem_kb=self._tile_vmem_kb)
            except PlanNotCompilable as e:
                raise LightGBMError(
                    f"model cannot be compiled for serving: {e}") from e
            planes, meta = device_planes(plan, self.device)
            gidx = torch.from_numpy(plan.gather_idx).to(self.device)
            cls = ex["stacked"].get("cls") if ex["num_class"] > 1 else None
            rec = build_records(
                plan, None if cls is None else cls.cpu().numpy())
            st = _ServeState(ex, plan, planes, meta, gidx, cls,
                             DeviceRecords.of(rec, self.device))
            self._probe_compiled(st)
            self._state = st

    @property
    def compiled_active(self) -> bool:
        """Is the compiled path serving (plan built, probe passed)?"""
        return self._state is not None

    @property
    def num_class(self) -> int:
        return self._state.export["num_class"]

    def num_feature(self) -> int:
        return int(self._booster.num_feature())

    def buckets(self) -> List[int]:
        """Every padding bucket this runtime can present to the device."""
        out = []
        b = 1
        while b < self.max_batch_rows:
            out.append(b)
            b <<= 1
        out.append(self.max_batch_rows)
        return out

    # ------------------------------------------------------------- probe
    def _probe_batch(self, ex: Dict, rows: int = 256) -> np.ndarray:
        """Deterministic adversarial probe batch: feature values
        clustered at the model's own split thresholds (maximum routing
        and accumulation diversity), NaN/zero sprinkles for the
        missing-value paths, plus plain gaussian noise so large
        exponent gaps and cancellations in the adder all fire."""
        nf = max(self.num_feature(), int(ex["stacked"]["min_features"]), 1)
        rng = np.random.RandomState(0)
        X = rng.randn(rows, nf)
        thr, feats = [], []
        for t in ex["trees"]:
            k = max(t.num_leaves - 1, 0)
            thr.append(np.asarray(t.threshold[:k], np.float64))
            feats.append(np.asarray(t.split_feature[:k], np.int64))
        if thr:
            thr = np.concatenate(thr)
            feats = np.concatenate(feats)
            for f in np.unique(feats):
                v = thr[feats == f]
                pick = v[rng.randint(len(v), size=rows)]
                noise = rng.randn(rows) * (np.std(v) + 1e-3)
                X[:, f] = np.where(rng.rand(rows) < 0.5, pick,
                                   pick + noise)
        X[rng.rand(rows, nf) < 0.03] = np.nan
        X[rng.rand(rows, nf) < 0.03] = 0.0
        return np.ascontiguousarray(X)

    def _probe_compiled(self, st: _ServeState) -> None:
        """Exact parity gate: the compiled path's raw f64 bits, and its
        converted f32 bits, must equal the host f64 gather/sum over the
        routing reference's slots (`ops.predict.predict_leaf_ensemble`
        on the stacked planes, on this runtime's device) for the probe
        batch.  Raises on any difference."""
        ex = st.export
        X = self._probe_batch(ex, rows=min(256, self.max_batch_rows))
        n = X.shape[0]
        slots = predict_leaf_ensemble(
            ex["stacked"], self._stage32(X, bucket_rows(
                n, self.max_batch_rows)))[:, :n].cpu().numpy()
        K = ex["num_class"]
        leaf_values = ex["leaf_values"]
        want = np.zeros((n, K), np.float64)
        for i in range(slots.shape[0]):
            want[:, i % K] += leaf_values[i, slots[i]]
        if K == 1:
            want = want[:, 0]
        got = self._compiled_chunk(X, st, want_raw=True)
        if got.shape != want.shape or not np.array_equal(
                got.view(np.uint64), want.view(np.uint64)):
            raise LightGBMError(
                "compiled parity probe failed: raw scores differ from the "
                "routing reference's f64 sum")
        if self._booster.objective_ is not None:
            got_c = self._compiled_chunk(X, st, want_raw=False)
            want_c = self._convert(want)
            if got_c.shape != want_c.shape or got_c.dtype != want_c.dtype \
                    or not np.array_equal(got_c.view(np.uint32),
                                          want_c.view(np.uint32)):
                raise LightGBMError(
                    "compiled parity probe failed: converted scores differ")

    # ----------------------------------------------------------- predict
    def warmup(self) -> int:
        """Run every padding bucket once (raw and, with an objective,
        converted), so the first live request pays no kernel build or
        allocator growth.  Returns the number of buckets warmed."""
        st = self._state
        nf = max(self.num_feature(),
                 int(st.export["stacked"]["min_features"]))
        sizes = self.buckets()
        for b in sizes:
            Z = np.zeros((b, nf), np.float64)
            self._compiled_chunk(Z, st, want_raw=True)
            if self._booster.objective_ is not None:
                self._compiled_chunk(Z, st, want_raw=False)
        return len(sizes)

    def predict(self, X, raw_score: bool = False) -> np.ndarray:
        """Scores for the rows of X: f64 raw sums ([N] or [N, K]) with
        `raw_score` or without an objective, else the objective's f32
        outputs.  Requests above `max_batch_rows` are chunked."""
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        st = self._state
        ex = st.export
        K = ex["num_class"]
        want_raw = raw_score or self._booster.objective_ is None
        n = X.shape[0]
        if n == 0:
            return np.zeros((0,) if K == 1 else (0, K),
                            np.float64 if want_raw else np.float32)
        if X.shape[1] < ex["stacked"]["min_features"]:
            raise LightGBMError(
                f"X has {X.shape[1]} features; the model splits on "
                f"feature {ex['stacked']['min_features'] - 1}")
        outs = [self._compiled_chunk(X[lo:lo + self.max_batch_rows], st,
                                     want_raw)
                for lo in range(0, n, self.max_batch_rows)]
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def _chunk_rows(self, n: int) -> int:
        """Device rows for a chunk of n: its bucket, padded on up to a
        multiple of ROW_BLOCK when an odd cap (max_batch_rows=3000)
        clamps the top bucket to a non-multiple."""
        b = bucket_rows(n, self.max_batch_rows)
        if b > ROW_BLOCK and b % ROW_BLOCK:
            b += ROW_BLOCK - b % ROW_BLOCK
        return b

    def _compiled_chunk(self, Xc: np.ndarray, st: _ServeState,
                        want_raw: bool) -> np.ndarray:
        ex = st.export
        n = Xc.shape[0]
        Xd = self._stage32(Xc, self._chunk_rows(n))
        conv = None if want_raw else self._booster.objective_.convert_output
        out = compiled_predict(Xd, st.planes, st.gidx, ex["value_f64"],
                               st.cls, meta=st.meta,
                               n_class=ex["num_class"], convert=conv,
                               records=st.records)
        return out[:n].cpu().numpy()

    def _stage32(self, Xc: np.ndarray, b: int) -> torch.Tensor:
        """`Xc` as f32 rows padded with zeros to `b`, on the device.
        f64 -> f32 saturates huge values to inf, the routing wanted
        (inf lies beyond every threshold and category span); the
        padding rows are sliced away by the callers."""
        buf = np.zeros((b, Xc.shape[1]), np.float32)
        with np.errstate(over="ignore"):
            buf[:Xc.shape[0]] = Xc
        return torch.from_numpy(buf).to(self.device)

    def _convert(self, raw: np.ndarray) -> np.ndarray:
        """The objective's link over host f64 raw scores, on the device,
        padded to the same row bucket the compiled path uses so both run
        the link on the same shapes."""
        n = raw.shape[0]
        pad = np.zeros((self._chunk_rows(n),) + raw.shape[1:], np.float64)
        pad[:n] = raw
        t = torch.from_numpy(pad).to(self.device).to(torch.float32)
        return self._booster.objective_.convert_output(t)[:n].cpu().numpy()
