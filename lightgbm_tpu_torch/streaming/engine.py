"""The shard-streamed grower: training without the [F, N] bin matrix on
the device.

The port's counterpart of `lightgbm_tpu/streaming/engine.py`
(`streaming_downgrade_reasons` `:83`, `streaming_spec` `:105`,
`StreamingWaveGrower` `:119`) and of the serial branch of
`lightgbm_tpu/mesh/placement.py:142 stream_shard_plan`.  The in-memory
growers hold the whole bin matrix on the device; this grower keeps only
the O(N) state there:

  resident:   payload [N, 3] f32 and leaf_id [N] i32 (with quantized
              gradients the lattice [3, N] int8), the tree's per-leaf
              histograms [LB, F, MB, 3] and the booster's scores;
  transient:  the shard being folded, [F, shard_rows], and the one
              before it (the staging that `datastore_budget_mb` sizes),
              and the wave's histogram carry.

A tree is the wave grower's (`ops/grow_wave.py make_wave_grower`): the
same pick loop on host numpy, the same searches and prune, on the same
histograms.  Only its two passes over the bins differ: each reads the
shard store in ascending shard order (`stream_shard_plan`) through the
`ShardPrefetcher`, one block on the device at a time:

  * `partition`: the wave's picks applied to each shard's rows of the
    resident leaf_id (the reference's `part_prog`, `:288-313`);
  * `hist`: the smaller children's histograms folded shard by shard
    into a carry (`ops/hist_kernel.py histogram_carry_*` in K1's order,
    two launches a shard; `ops/hist_kernel_q.py histogram_carry_q_*`,
    one launch a shard into int32 cells; the plain carries of
    `ops/histogram.py` for hist_impl "plain" and "packed").
    The f32 carry keeps K1's order of adds, which depends on each slot's
    whole row count L: the carry is given L, counted on the resident
    leaf_id after the partition pass.  With the fused spec the children's
    candidates come from K3 (`split_scan`) over the carried histograms
    with the children's sums, where the in-memory wave has them from K2
    (K5); the larger children's from K3 as in memory.

So a wave costs two sweeps of the store where the reference's costs one
(it partitions and folds each shard in one program, its order of adds
not needing L): a tree takes 1 + 2 x (waves that build histograms) + 1
(the tree-full wave's partition) sweeps, against the reference's
ceil((L - 1) / W) + 1.  A leafwise booster streams as a width-1 wave
(`streaming_spec`), which is strict best-first order.

Byte identity with in-memory training holds by construction: a shard's
bins are the codes of the assembled matrix; the carries add in the
in-memory histograms' order (the f32 kernel carry K1's, the plain
carries `index_add_`'s row order, the integer carries in any order); the
split math is the wave grower's own code on equal inputs.

Telemetry under the reference's names: the `stream.pass` span
(`phase` root, partition or wave) with its four stages (prefetch wait,
H2D, device fold, host harvest); the counters `stream.shard_passes`,
`stream.shards_read`, `stream.stalls` and `datastore.prefetch.hit` /
`.stall`; the gauges `stream.shards`, `stream.peak_staging_mb` and
`stream.peak_device_mb`; the memory ledger's `stream.staging`,
`train.scores{buf=stream}` and `train.hist_carry`, and each pass's
audit of the staging against `datastore_budget_mb`.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import telemetry
from ..datastore.prefetch import PrefetchRunStats, ShardPrefetcher
from ..ops.fused_kernel import split_scan
from ..ops.grow import GrowerSpec
from ..ops.grow_wave import make_wave_grower, partition_rows, wave_sizes
from ..ops.hist_kernel import (histogram_carry_finalize, histogram_carry_init,
                               histogram_carry_update)
from ..ops.hist_kernel_q import (histogram_carry_q_finalize,
                                 histogram_carry_q_init,
                                 histogram_carry_q_update,
                                 quantized_lattice_rows)
from ..ops.histogram import (hist_stream_finalize, hist_stream_init,
                             hist_stream_packed_finalize,
                             hist_stream_packed_init,
                             hist_stream_packed_update, hist_stream_update)
from ..telemetry import REGISTRY
from ..telemetry.memledger import MEMLEDGER

#: sweeps of the shard store by the streamed growers, by pass phase
SWEEPS = {"root": 0, "partition": 0, "wave": 0}

#: pinned host buffers that alternate between a pass's shards
STAGING_BUFFERS = 2


def stream_shard_plan(store) -> List[tuple]:
    """The serial read order of a streamed pass: every shard, ascending
    (the reference's `stream_shard_plan` without a mesh).  One order,
    since the f32 histograms' adds follow the rows'."""
    return [(k, None) for k in range(store.n_shards)]


def streaming_downgrade_reasons(spec: GrowerSpec, store) -> List[str]:
    """Why `spec` cannot stream (empty: it can), the reference's list:
    the modes whose state needs the assembled matrix."""
    reasons = []
    if store is None:
        reasons.append("no datastore (external_memory off)")
    if spec.bundled:
        reasons.append("EFB bundling (bundle expansion needs the "
                       "assembled bundle columns)")
    if spec.forced_splits:
        reasons.append("forced splits")
    if spec.monotone_intermediate:
        reasons.append("monotone_constraints_method=intermediate")
    if spec.hist_pool_slots > 0:
        reasons.append("bounded histogram pool")
    return reasons


def streaming_spec(spec: GrowerSpec, policy: str) -> GrowerSpec:
    """The streamed grower's wave spec for a resolved grow policy: a
    leafwise booster streams as a width-1 wave with a full strict tail
    and no gain floor or overgrow, which is strict best-first order."""
    if policy == "wave":
        return spec
    return spec._replace(wave_width=1, wave_strict_tail=spec.num_leaves,
                         wave_gain_ratio=0.0, wave_overgrow=0.0)


class StreamedRows:
    """One tree's rows streamed from the shard store: the wave grower's
    row source (`ops/grow_wave.py MemoryRows`'s `hist_cache`, `hist` and
    `partition`), one sweep of the store a call."""

    def __init__(self, eng: "StreamingWaveGrower", payload: torch.Tensor,
                 feat: Dict, scan_kw: Dict):
        self.eng, self.payload, self.feat = eng, payload, feat
        self.scan_kw = scan_kw
        self.n_rows = payload.shape[0]
        spec = eng.spec
        self.qs = feat.get("qscales")
        self.pw3 = quantized_lattice_rows(
            payload, self.qs[0], self.qs[1], debug=spec.debug_checks) \
            if spec.hist_impl == "kernel_q" else None
        self.wave = 0
        self.resident = [payload] + ([self.pw3] if self.pw3 is not None
                                     else [])

    def hist_cache(self, leaves: int, hb: int) -> torch.Tensor:
        hist = torch.empty((leaves, self.eng.store.n_features, hb, 3),
                           dtype=torch.float32, device=self.payload.device)
        MEMLEDGER.assign("train.hist_carry", [hist])
        return hist

    def _carry(self, leaf_id: torch.Tensor, slots: torch.Tensor):
        """(update(carry, bins, row0, rows), finalize(carry), carry, its
        tensors) of the spec's histogram family."""
        spec, store = self.eng.spec, self.eng.store
        f, mb, n = store.n_features, spec.max_bin, store.n_rows
        impl, s = spec.hist_impl, slots.shape[0]
        pay = self.payload
        if impl == "kernel":
            # the f32 kernel carry's order needs each slot's row count
            lengths = torch.bincount(leaf_id, minlength=wave_sizes(spec)[0])[
                slots.long()].to(torch.int32) \
                if pay.device.type == "cuda" else None
            carry = histogram_carry_init(n, f, slots, mb, lengths)
            return (lambda c, b, r0, r: histogram_carry_update(
                c, b, pay[r0:r0 + r], leaf_id[r0:r0 + r]),
                histogram_carry_finalize, carry, carry.tensors())
        if impl == "kernel_q":
            carry = histogram_carry_q_init(f, slots, mb)
            return (lambda c, b, r0, r: histogram_carry_q_update(
                c, b, self.pw3[:, r0:r0 + r].contiguous(),
                leaf_id[r0:r0 + r]),
                lambda c: histogram_carry_q_finalize(c, self.qs[0],
                                                     self.qs[1]),
                carry, carry.tensors())
        if impl == "plain":
            acc = hist_stream_init(f, s, mb, device=pay.device)
            return (lambda c, b, r0, r: hist_stream_update(
                c, b, pay[r0:r0 + r], leaf_id[r0:r0 + r], slots, mb),
                lambda c: hist_stream_finalize(c, s, mb), acc, [acc])
        chl = spec.packed_const_hess_level
        acc = hist_stream_packed_init(f, s, mb, chl, device=pay.device)
        return (lambda c, b, r0, r: hist_stream_packed_update(
            c, b, pay[r0:r0 + r], leaf_id[r0:r0 + r], slots, mb,
            self.qs[0], self.qs[1], chl),
            lambda c: hist_stream_packed_finalize(c, s, mb, self.qs[0],
                                                  self.qs[1], chl),
            acc, list(acc.values()))

    def hist(self, leaf_id: torch.Tensor, slots: torch.Tensor,
             parent: torch.Tensor):
        """(hist [S, F, MB, 3], K3's candidates or None) of the leaves
        `slots`, folded from one sweep of the store."""
        eng = self.eng
        phase = "wave" if self.wave else "root"
        update, finalize, carry, held = self._carry(leaf_id, slots)
        for t in held:                  # freed with the carry (weakref)
            MEMLEDGER.register("train.hist_carry", t)
        MEMLEDGER.assign("train.scores", self.resident + [leaf_id],
                         buf="stream")
        with eng.sweep(phase, self.wave, extra=held) as (blocks, prof):
            for rows, row0, dev in blocks:
                t_f = time.perf_counter()
                update(carry, dev, row0, rows)
                prof["device_fold_s"] += time.perf_counter() - t_f
            t_h = time.perf_counter()
            h = finalize(carry)
            prof["host_harvest_s"] += time.perf_counter() - t_h
        self.wave += 1
        if not eng.spec.fused:
            return h, None
        return h, split_scan(h, self.feat["nb"], self.feat["missing"],
                             parent, **self.scan_kw)

    def partition(self, leaf_id: torch.Tensor, picks: List[tuple],
                  mask_dev, slots: torch.Tensor) -> torch.Tensor:
        """The wave's picks applied to the resident leaf_id, shard by
        shard."""
        eng = self.eng
        out = leaf_id.clone()
        with eng.sweep("partition", self.wave) as (blocks, prof):
            for rows, row0, dev in blocks:
                t_f = time.perf_counter()
                out[row0:row0 + rows] = partition_rows(
                    dev, leaf_id[row0:row0 + rows], picks, mask_dev, slots,
                    self.feat)
                prof["device_fold_s"] += time.perf_counter() - t_f
        return out


def _nbytes(tensors) -> int:
    """Bytes of device tensors, from their metadata (no sync)."""
    return sum(t.numel() * t.element_size() for t in tensors or ()
               if t is not None)


class StreamingWaveGrower:
    """The grower of `spec` with the growers' contract, `(bins_fm, grad,
    hess, sample_weight, feat, allowed) -> DeviceTree`, called with
    `bins_fm=None`: the bins stream from `store`.  One a training run; it
    owns the run's prefetch accounting (`stats`) and the staging
    watermarks."""

    def __init__(self, spec: GrowerSpec, store, *, prefetch_depth: int = 2,
                 run_stats: Optional[PrefetchRunStats] = None,
                 budget_mb: float = 0.0):
        reasons = streaming_downgrade_reasons(spec, store)
        if reasons:
            raise ValueError("spec cannot stream: " + "; ".join(reasons))
        self.spec = spec
        self.store = store
        self.depth = max(1, int(prefetch_depth))
        self.stats = run_stats if run_stats is not None \
            else PrefetchRunStats()
        self.plan = stream_shard_plan(store)
        self.budget_mb = float(budget_mb)
        #: the staging the budget sizes (the shard folded and the one
        #: before it), and that plus the resident state, at their peaks
        self.peak_staging_bytes = 0
        self.peak_device_bytes = 0
        self._resident_bytes = 0
        self._tree_resident: List[torch.Tensor] = []
        self._tree_idx = -1
        self._staging: List[list] = []
        self._grow = make_wave_grower(spec, rows=self._rows)
        REGISTRY.gauge("stream.shards").set(store.n_shards)

    def _rows(self, payload, feat, scan_kw) -> StreamedRows:
        src = StreamedRows(self, payload, feat, scan_kw)
        self._tree_resident = src.resident
        return src

    @contextlib.contextmanager
    def sweep(self, phase: str, wave: int, extra=()):
        """One pass over the store: `with eng.sweep(phase, wave) as
        (blocks, prof)` gives the shards' device blocks and the pass's
        stage profile, and closes the `stream.pass` span with them; the
        prefetcher stops on any exit."""
        SWEEPS[phase] += 1
        prof = {"prefetch_wait_s": 0.0, "h2d_s": 0.0,
                "device_fold_s": 0.0, "host_harvest_s": 0.0}
        t0 = time.perf_counter()
        self._resident_bytes = _nbytes(self._tree_resident) + _nbytes(extra)
        blocks = self._stream(prof)
        with telemetry.span("stream.pass", phase=phase) as sp, \
                MEMLEDGER.oom_guard("stream.fold"):
            try:
                yield blocks, prof
            finally:
                blocks.close()
                wall = time.perf_counter() - t0
                sp.set(wall_s=round(wall, 6), tree=self._tree_idx,
                       wave=wave, shards=len(self.plan),
                       **{k: round(v, 6) for k, v in prof.items()})
                REGISTRY.histogram("stream.pass.wall").observe(wall)
                for k, v in prof.items():
                    REGISTRY.histogram("stream.pass." + k[:-2]).observe(v)

    def _h2d(self, block: np.ndarray, i: int) -> torch.Tensor:
        """A shard's block on the training device: on the CPU the block
        itself; on a CUDA device through one of two pinned buffers, each
        reused only once the copy that read it last has finished."""
        dev = self._device
        carrier = np.int16 if block.dtype == np.uint16 else np.uint8
        src = torch.from_numpy(block.view(carrier))
        if dev.type != "cuda":
            return src.view(torch.uint16) if carrier is np.int16 else src
        if not self._staging:
            cells = self.store.n_features * max(
                self.store.rows_of(k) for k in range(self.store.n_shards))
            self._staging = [[torch.empty(cells, dtype=src.dtype,
                                          pin_memory=True), None]
                             for _ in range(STAGING_BUFFERS)]
        slot = self._staging[i % STAGING_BUFFERS]
        if slot[1] is not None:
            slot[1].synchronize()
        host = slot[0][:src.numel()].view(src.shape)
        host.copy_(src)
        out = torch.empty(src.shape, dtype=src.dtype, device=dev)
        out.copy_(host, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out.view(torch.uint16) if carrier is np.int16 else out

    def _stream(self, prof: Dict[str, float]):
        """(rows, row0, device block) over the shard plan; `prof` gathers
        the time blocked on the prefetcher and the H2D copies."""
        self.stats.start_pass()
        REGISTRY.counter("stream.shard_passes").inc()

        def on_hit():
            self.stats.hit()
            REGISTRY.counter("datastore.prefetch.hit").inc()

        def on_stall():
            self.stats.stall()
            REGISTRY.counter("datastore.prefetch.stall").inc()
            REGISTRY.counter("stream.stalls").inc()

        pf = ShardPrefetcher(self.store, payload="bins", depth=self.depth,
                             plan=self.plan, on_hit=on_hit,
                             on_stall=on_stall)
        shards_read = REGISTRY.counter("stream.shards_read")
        prev = 0
        it = iter(pf)
        try:
            for i in range(len(self.plan) + 1):
                t0 = time.perf_counter()
                try:
                    _k, row0, block = next(it)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                dev = self._h2d(block, i)
                prof["prefetch_wait_s"] += t1 - t0
                prof["h2d_s"] += time.perf_counter() - t1
                staged = block.nbytes + prev
                self.peak_staging_bytes = max(self.peak_staging_bytes,
                                              staged)
                self.peak_device_bytes = max(self.peak_device_bytes,
                                             staged + self._resident_bytes)
                prev = block.nbytes
                # freed when the next shard replaces it (weakref)
                MEMLEDGER.register("stream.staging", dev)
                shards_read.inc()
                yield block.shape[1], row0, dev
        finally:
            it.close()
            pf.close()
            self.stats.absorb(pf)
            REGISTRY.gauge("stream.peak_staging_mb").set(
                round(self.peak_staging_bytes / 2 ** 20, 3))
            REGISTRY.gauge("stream.peak_device_mb").set(
                round(self.peak_device_bytes / 2 ** 20, 3))
            MEMLEDGER.audit(
                "datastore_budget_mb", self.budget_mb * 2 ** 20,
                self.peak_staging_bytes, site="stream.pass",
                peak_staging_mb=round(self.peak_staging_bytes / 2 ** 20, 3))
            REGISTRY.gauge("datastore.peak_resident_mb").set(
                round(self.stats.peak_resident_bytes / 2 ** 20, 3))

    def __call__(self, bins_fm, grad, hess, sample_weight, feat, allowed):
        del bins_fm                     # streamed, never assembled
        self._device = grad.device
        self._tree_idx += 1
        return self._grow(None, grad, hess, sample_weight, feat, allowed)
