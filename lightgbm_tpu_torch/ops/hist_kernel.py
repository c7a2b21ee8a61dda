"""The multi-leaf histogram: the K1 kernel's wrapper, launch plan, plain
version and order-exact model.

The port's counterpart of `lightgbm_tpu/ops/pallas_hist.py`'s K1 entry
points (`pallas_histogram_multi`, `_rows`, launcher `_run_kernel_multi`,
kernel `_hist_kernel_multi`).  `histogram_multi(bins_fm, payload,
leaf_id, slots, max_bin)` returns [S, F, MB, 3] f32: cell (s, f, b, c)
sums `payload[:, c]` over the rows where `leaf_id == slots[s]` and
`bins_fm[f] == b`; a slot that matches no row gives zeros.

CUDA tensors launch the hand-written kernel `csrc/histogram.cu` (its
first stage `csrc/hist_common.cuh`, shared with K2) with the plan of
`launch_plan`; CPU tensors run `histogram_multi_plain`, which is
`ops/histogram.py leaf_histogram` per slot and so bitwise equal to JAX's
`segment_sum`.  There is no fallback from one to the other: a CUDA
tensor launches the kernel or raises.

The kernel's numbers: counts are exact (integer sums below 2^24); g and
h agree with the plain version per cell within `1e-4 * sum|x| + 1e-6`
(`sum|x|` over the cell's rows), the tolerance the reference gives its
own Pallas path (`pallas_hist.py` `probe`); and they equal, bit for bit,
`histogram_multi_ordered`, which adds on the CPU in the order
`hist_common.cuh` documents.  So two launches on the same inputs give
the same bits.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.log import LightGBMError
from .histogram import leaf_histogram

#: histogram-kernel launches made by `histogram_multi`
HIST_LAUNCHES = 0

#: most slots one call takes (the reference's `MULTI_CHUNK`)
MULTI_CHUNK = 14

#: the first stage (`csrc/hist_common.cuh`): rows a block of the row-list
#: kernels; the histogram kernel's 8-warp blocks (one feature a warp), up
#: to four an SM; shared memory a block and an SM can have on an H100 (1
#: KB of an SM's is reserved for each block), and its SMs
_LIST_ROWS = 8192
#: rows a piece of a slot's list holds at least (fewer: fewer pieces)
_MIN_PIECE = 256
_WARPS = 8
_MAX_BLOCKS_PER_SM = 4
_SMEM_MAX = 227 * 1024
_SM_SMEM = 228 * 1024
_BLOCK_RESERVED = 1024
_SMS = 132
#: the launch plan's cost model, used only to pick the chunk count:
#: device time of one 32-row batch of one (slot, feature) on one warp
#: (an estimate, on the low side),
#: and the rate at which the chunk partials are written and read back
_NS_PER_BATCH = 300.0
_BYTES_PER_NS = 3350.0


def smem_bytes(feature_group: int, max_bin: int) -> int:
    """Shared memory of one histogram block (`hist_common.cuh
    partial_smem_bytes`): the [feature_group, MB] histograms of 16-byte
    cells (g, h, w and the cell's group word) and each warp's staging
    buffer of 96 floats."""
    return feature_group * max_bin * 16 + _WARPS * 96 * 4


def max_bin_limit() -> int:
    """Largest `max_bin` a launch takes: one feature's histogram a
    block."""
    return (_SMEM_MAX - smem_bytes(1, 0)) // 16


def blocks_per_sm(smem: int) -> int:
    """Histogram blocks an SM holds at `smem` bytes a block."""
    return max(1, min(_MAX_BLOCKS_PER_SM,
                      _SM_SMEM // (smem + _BLOCK_RESERVED)))


def row_scratch_ints(n: int, s: int) -> int:
    """int32 scratch of the row list: the list [n], the per-block counts
    and offsets [s * ceil(n / 8192)] and the slots' starts [s + 1]."""
    return n + s * -(-n // _LIST_ROWS) + s + 1


#: the first stage's tickets, one int32 per (device, stream): 0 between
#: launches (the kernel that takes one sets it back), so launches that
#: share a ticket run one after the other on their stream
_TICKETS = {}


def ticket(device, stream: int) -> int:
    """Pointer to the first stage's ticket for `stream` on `device`;
    call with that stream current (the ticket is zeroed on it)."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t.data_ptr()


def first_stage_scratch(n: int, s: int, f: int, max_bin: int, chunks: int,
                        device):
    """(scratch, rowbuf pointer, workspace pointer) of one launch: one
    int32 allocation holding the row scratch (`row_scratch_ints`) and the
    f32 workspace [chunks, S, F, MB, 3]."""
    rows = row_scratch_ints(n, s)
    scratch = torch.empty(rows + chunks * s * f * max_bin * 3,
                          dtype=torch.int32, device=device)
    ptr = scratch.data_ptr()
    return scratch, ptr, ptr + 4 * rows


class LaunchPlan(NamedTuple):
    """One launch of the first stage: the histogram kernel's grid is
    (s * groups, chunks); a block adds `feature_group` features (one a
    warp) of one slot over piece c of the slot's listed rows; the
    workspace is [chunks, S, F, MB, 3] f32."""
    feature_group: int
    groups: int
    chunks: int
    smem: int


def plan_launch(n: int, f: int, s: int, max_bin: int, smem_of,
                ns_per_batch: float) -> LaunchPlan:
    """A histogram kernel's launch over `n` >= 1 rows, `f` features and
    `s` slots of `max_bin` bins, for blocks of `smem_of(feature_group,
    max_bin)` bytes of shared memory and partials of 12 bytes a cell
    (K1's and K2's, and K4's and K5's, `hist_kernel_q.launch_plan_q`).
    Feature group: of those whose block fits, the one with the most warps
    adding at once on an SM (blocks an SM x features a block), then the
    fewest groups.  Chunks: the count that balances the adds (fewer rows
    a warp with more chunks, `ns_per_batch` a 32-row batch) against the
    partials written and read back (more bytes with more chunks), at most
    the blocks the SMs hold at once and a batch of 32 rows each."""
    best = None
    for f_g in range(1, min(f, _WARPS) + 1):
        f_g = -(-f // -(-f // f_g))                 # groups cut evenly
        smem = smem_of(f_g, max_bin)
        if smem > _SMEM_MAX:
            continue
        bps = blocks_per_sm(smem)
        key = (bps * f_g, f_g)
        if best is None or key > best[0]:
            best = (key, f_g, smem, bps)
    _, f_g, smem, bps = best
    groups = -(-f // f_g)
    busy = s * groups * f_g                        # warps adding at once
    adds_ns = n * f / 32 / busy * ns_per_batch
    partial_ns = 2 * s * f * max_bin * 12 / _BYTES_PER_NS
    chunks = min(max(1, _SMS * bps // (s * groups)), -(-n // 32),
                 max(1, round(math.sqrt(adds_ns / partial_ns))))
    return LaunchPlan(f_g, groups, chunks, smem)


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, f: int, s: int, max_bin: int) -> LaunchPlan:
    """K1's and K2's first stage (`plan_launch`) over `n` >= 1 rows, `f`
    features and `s` <= 14 slots of `max_bin` bins."""
    limit = max_bin_limit()
    if max_bin > limit:
        raise LightGBMError(
            f"max_bin {max_bin} needs {smem_bytes(1, max_bin)} B of shared "
            f"memory a block; the histogram kernel takes max_bin up to "
            f"{limit} ({_SMEM_MAX} B)")
    return plan_launch(n, f, s, max_bin, smem_bytes, _NS_PER_BATCH)


def _check(bins_fm, payload, leaf_id, slots, max_bin):
    if bins_fm.dim() != 2 or bins_fm.dtype not in (torch.uint8,
                                                   torch.uint16):
        raise LightGBMError("bins_fm must be [F, N] uint8 or uint16")
    f, n = bins_fm.shape
    if payload.shape != (n, 3) or payload.dtype != torch.float32:
        raise LightGBMError(f"payload must be [{n}, 3] float32")
    if leaf_id.shape != (n,) or leaf_id.dtype != torch.int32:
        raise LightGBMError(f"leaf_id must be [{n}] int32")
    if slots.dim() != 1 or slots.dtype != torch.int32:
        raise LightGBMError("slots must be [S] int32")
    if not 1 <= slots.shape[0] <= MULTI_CHUNK:
        raise LightGBMError(f"{slots.shape[0]} slots: a call takes 1 to "
                            f"{MULTI_CHUNK}")
    if max_bin < 1:
        raise LightGBMError(f"max_bin must be positive, got {max_bin}")
    if any(t.device != bins_fm.device for t in (payload, leaf_id, slots)):
        raise LightGBMError("histogram inputs lie on different devices")


def histogram_multi_plain(bins_fm: torch.Tensor, payload: torch.Tensor,
                          leaf_id: torch.Tensor, slots: torch.Tensor,
                          max_bin: int) -> torch.Tensor:
    """Plain version: `leaf_histogram` of each slot's rows, stacked to
    [S, F, MB, 3]."""
    _check(bins_fm, payload, leaf_id, slots, max_bin)
    return torch.stack([leaf_histogram(bins_fm, payload, leaf_id == s,
                                       max_bin)
                        for s in slots.tolist()])


class RowLists(NamedTuple):
    """The first stage's row lists as `row_count_kernel` and
    `row_list_kernel` build them (`csrc/hist_common.cuh`), in numpy:
    `counts` [S, blocks] each 8192-row block's rows of each slot (a row
    counts for the first slot equal to its leaf id), `offsets` [S,
    blocks] their exclusive prefix over (slot, block) in that order,
    `slot_start` [S + 1] (a slot after its first occurrence, or with no
    row, lists nothing), `list` [total] every slot's rows in row order,
    one slot after the other, and `lattice` [total] each listed row's
    int8 lattice packed into bytes 0-2 of a uint32 (K4's and K5's
    instance, given `pw3`; else None)."""
    counts: np.ndarray
    offsets: np.ndarray
    slot_start: np.ndarray
    list: np.ndarray
    lattice: object


def row_lists_plain(leaf_id, slots, pw3=None) -> RowLists:
    """`RowLists` of leaf ids [N] i32, slots [S] and optionally the
    lattice pw3 [3, N] int8 (tensors or arrays)."""
    lid = np.asarray(torch.as_tensor(leaf_id).cpu(), np.int64)
    sl = np.asarray(torch.as_tensor(slots).cpu(), np.int64)
    n = lid.size
    nb = -(-n // _LIST_ROWS)
    first = np.full(n, -1, np.int64)       # the first equal slot, or -1
    for k in range(sl.size - 1, -1, -1):
        first[lid == sl[k]] = k
    block = np.arange(n) // _LIST_ROWS
    counts = np.zeros((sl.size, nb), np.int64)
    np.add.at(counts, (first[first >= 0], block[first >= 0]), 1)
    flat = counts.reshape(-1)
    offsets = (np.cumsum(flat) - flat).reshape(counts.shape)
    slot_start = np.append(offsets[:, 0] if nb else np.zeros(sl.size,
                                                               np.int64),
                           flat.sum())
    order = np.argsort(first * (n + 1) + np.arange(n), kind="stable")
    rows = order[first[order] >= 0]
    lattice = None
    if pw3 is not None:
        pw = np.asarray(torch.as_tensor(pw3).cpu(), np.int8)[:, rows]
        b = pw.view(np.uint8).astype(np.uint32)
        lattice = b[0] | (b[1] << 8) | (b[2] << 16)
    return RowLists(counts, offsets, slot_start, rows, lattice)


def piece_bounds(length: int, chunks: int) -> np.ndarray:
    """[P + 1] bounds of the pieces a slot's `length` listed rows are cut
    into, as the kernel cuts them (`hist_common.cuh slot_rows`): P =
    min(chunks, max(1, length // 256)) pieces, piece c [c * length // P,
    (c + 1) * length // P)."""
    pieces = min(chunks, max(1, length // _MIN_PIECE))
    return np.arange(pieces + 1, dtype=np.int64) * length // pieces


def histogram_multi_ordered(bins_fm: torch.Tensor, payload: torch.Tensor,
                            leaf_id: torch.Tensor, slots: torch.Tensor,
                            max_bin: int) -> torch.Tensor:
    """The kernel's sums on the CPU, added in the order `csrc/
    hist_common.cuh` documents under `launch_plan`'s chunk count: for
    each slot, its L rows in row order cut into pieces (`piece_bounds`);
    for each feature, a
    piece's rows cut into batches of 32 from the piece's first row;
    within a batch the rows of one bin summed in row order from +0.0
    (f32); a piece's cell adding its batches' sums in order from +0.0
    (`np.add.at` adds in index order); the pieces' partials summed in
    index order.  For tests and chip_smoke.py: the CUDA kernel equals it
    bit for bit."""
    _check(bins_fm, payload, leaf_id, slots, max_bin)
    f, n = bins_fm.shape
    s = slots.shape[0]
    out = np.zeros((s, f, max_bin, 3), np.float32)
    if n == 0 or f == 0:
        return torch.from_numpy(out)
    chunks = launch_plan(n, f, s, max_bin).chunks
    bins = bins_fm.cpu().numpy()
    pay = payload.cpu().numpy()
    lid = leaf_id.cpu().numpy()
    for i, slot in enumerate(slots.tolist()):
        rows = np.flatnonzero(lid == slot)
        if rows.size == 0:
            continue
        starts = piece_bounds(rows.size, chunks)
        piece = np.searchsorted(starts, np.arange(rows.size), "right") - 1
        pos = np.arange(rows.size) - starts[piece]
        batch = np.cumsum(np.r_[0, np.diff(piece * (n + 1) + pos // 32)
                                != 0])                # non-decreasing
        lane = pos % 32
        p = pay[rows]
        for fi in range(f):
            b = bins[fi, rows].astype(np.int64)
            ok = b < max_bin
            keys, first, gid = np.unique(batch[ok] * max_bin + b[ok],
                                         return_index=True,
                                         return_inverse=True)
            gsum = np.zeros((keys.size, 3), np.float32)
            ln, pv = lane[ok], p[ok]
            for l_ in range(32):               # lane order from +0.0
                sel = ln == l_
                gsum[gid[sel]] += pv[sel]
            part = np.zeros((starts.size - 1, max_bin, 3), np.float32)
            np.add.at(part, (piece[ok][first], keys % max_bin), gsum)
            acc = part[0].copy()
            for c in range(1, starts.size - 1):
                acc += part[c]
            out[i, fi] = acc
    return torch.from_numpy(out)


def histogram_multi(bins_fm: torch.Tensor, payload: torch.Tensor,
                    leaf_id: torch.Tensor, slots: torch.Tensor,
                    max_bin: int, plan_features: int = 0) -> torch.Tensor:
    """[S, F, MB, 3] f32 histograms of the leaves `slots` [S] (1 to 14),
    over bins `bins_fm` [F, N] u8/u16, payload [N, 3] f32 and row leaf
    ids `leaf_id` [N] i32.  CUDA tensors launch `csrc/histogram.cu`;
    CPU tensors run `histogram_multi_plain`.  `plan_features` > 0 takes
    the pieces of the plan for that many features (a block of a wider
    matrix: each feature's cells then add in the wider launch's order,
    bit for bit)."""
    global HIST_LAUNCHES
    if bins_fm.device.type == "cpu":
        return histogram_multi_plain(bins_fm, payload, leaf_id, slots,
                                     max_bin)
    if bins_fm.device.type != "cuda":
        raise LightGBMError(f"no histogram kernel for {bins_fm.device}")
    _check(bins_fm, payload, leaf_id, slots, max_bin)
    for t in (bins_fm, payload, leaf_id, slots):
        if not t.is_contiguous():
            raise LightGBMError("histogram inputs must be contiguous")
    f, n = bins_fm.shape
    s = slots.shape[0]
    plan = launch_plan(max(n, 1), f, s, max_bin)
    if plan_features > 0:
        plan = plan._replace(chunks=launch_plan(max(n, 1), plan_features, s,
                                                max_bin).chunks)
    out = torch.empty((s, f, max_bin, 3), dtype=torch.float32,
                      device=bins_fm.device)
    if n == 0 or f == 0:
        return out.zero_()
    scratch, rowbuf, work = first_stage_scratch(n, s, f, max_bin,
                                                plan.chunks, bins_fm.device)
    from ..compiler import _build
    lib = _build.load("histogram")
    rc = _build.on_stream(bins_fm.device, lambda stream: lib.lgbt_histogram(
        bins_fm.data_ptr(), bins_fm.element_size(), payload.data_ptr(),
        leaf_id.data_ptr(), slots.data_ptr(), n, f, s, max_bin,
        plan.feature_group, plan.chunks, rowbuf,
        ticket(bins_fm.device, stream), work, out.data_ptr(),
        ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"histogram kernel launch failed: CUDA error "
                            f"{rc}")
    HIST_LAUNCHES += 1
    return out


# ---- the carry: K1's order over one shard at a time -------------------
#
# The shard-streamed grower folds the rows of one shard after the other
# into a histogram carried on the device (`streaming/engine.py`), and the
# data learner's ring sends it from rank to rank (`parallel/learner.py`).
# Its contract: once the last shard has been folded, the finalized carry
# is `histogram_multi` over all N rows bit for bit, the order of adds of
# `hist_common.cuh` under `launch_plan(N, F, S, MB)`.  That order hangs
# on each slot's whole list: its L rows are cut into pieces of
# `piece_bounds`, each piece into batches of 32 counted from the piece's
# first row, and the pieces' partials are summed in index order from the
# first.  So the carry is given every slot's L before the first shard.
# Shards come in row order, so at a shard boundary the pieces before a
# slot's open one are complete and those after it untouched, and the
# carry holds only what crosses a boundary (`csrc/histogram.cu`): the
# completed pieces' left fold (`prefix`, the histogram once every row is
# folded), the open piece's partial (`open`), each slot's rank (its rows
# folded so far), and the rows of its open batch (at most 31: bins and
# payload), the last two in halves that alternate between shards under a
# device `parity` the kernel flips.

#: carry-kernel launches made by `histogram_carry_update` (one a group
#: of up to 14 slots, each two kernels: the row list and the fold)
HIST_CARRY_LAUNCHES = 0

#: rows of a batch, and of the open batch a slot carries at most
_BATCH = 32
#: rows a block of the carry's list kernel
_CARRY_LIST_ROWS = 2048

#: the carried state of one group of slots on a CUDA device, in the
#: order a hop of the ring moves it
CARRY_STATE = ("prefix", "open", "rank", "pend_bin", "pend_pay", "parity")


def carry_height(n: int, chunks: int, lengths, slots) -> int:
    """Rows of the fold kernel's grid for a shard of `n` rows of the
    slots `slots` with `lengths` rows each over all N (host lists): at
    least the rows the list kernel lays out, one a piece each slot's
    ranks reach (`csrc/histogram.cu carry_list_kernel`).  A slot of L
    rows has P = min(chunks, max(1, L // 256)) pieces of at least L // P
    rows, so its `len` rows of the shard reach at most len // (L // P) +
    2 of them and never more than P; the shard's rows count once a slot
    value, as often as the value repeats among the slots."""
    total, piece = 0, None
    for big_l in lengths:
        if big_l > 0:
            p = min(chunks, max(1, big_l // _MIN_PIECE))
            total += p
            piece = big_l // p if piece is None else min(piece,
                                                         big_l // p)
    if piece is None:
        return 1
    mult = max(list(slots).count(v) for v in slots)
    height = min(total, mult * (n // piece) + 2 * len(slots))
    if height > 65535:
        raise LightGBMError(f"the carry's fold needs {height} grid rows "
                            "for one shard; a launch takes 65535")
    return height


def carry_scratch_ints(n: int, s: int, f: int, max_bin: int,
                       height: int) -> int:
    """int32 scratch of one shard's fold: each slot's row list [s, n],
    row count [s] and first grid row [s + 1], then (from an even offset)
    the partials of the grid's blocks [height, f, max_bin, 3] f32."""
    return ((s * n + 2 * s + 2) & ~1) + height * f * max_bin * 3


def carry_sync_ints(n: int, s: int, f: int) -> int:
    """int32 words a stream's carry launches share, 0 between launches:
    the list kernel's look-back [s * ceil(n / 2048)] u64, its ticket and
    finished blocks, and a fold ticket a (slot, feature)."""
    return 2 * s * -(-n // _CARRY_LIST_ROWS) + 2 + s * f


def carry_smem_bytes(max_bin: int) -> int:
    """Shared memory of one fold block (`histogram.cu carry_smem_bytes`):
    a feature's cells [max_bin, 3] f32, each warp's lane buffer of 96
    words and two round buffers of the 7 computing warps' batch sums."""
    return 12 * max_bin + _WARPS * 96 * 4 + 2 * (_WARPS - 1) * 128 * 4


#: the carry launches' shared words, one zeroed int32 tensor per (device,
#: stream), grown on demand: the kernels leave them 0, so launches on
#: one stream share them, one after the other
_CARRY_SYNC = {}


def carry_sync(device, stream: int, ints: int) -> int:
    """Pointer to at least `ints` zeroed words for the carry launches on
    `stream` of `device`; call with that stream current."""
    key = (device.index, stream)
    t = _CARRY_SYNC.get(key)
    if t is None or t.numel() < ints:
        t = _CARRY_SYNC[key] = torch.zeros(max(ints, 1024),
                                           dtype=torch.int32, device=device)
    return t.data_ptr()


class HistCarry:
    """One carried histogram of `slots` over N rows.  CPU: the plain f32
    carry of `ops/histogram.py` (`acc`).  CUDA: per group of up to 14
    slots (`MULTI_CHUNK`, as `fused_hist_split` launches them) the
    kernel's state (`CARRY_STATE`), `groups`."""

    __slots__ = ("slots", "max_bin", "n_features", "acc", "first", "groups")

    def __init__(self, slots, max_bin, n_features, acc=None, first=None,
                 groups=None):
        self.slots = slots
        self.max_bin = max_bin
        self.n_features = n_features
        self.acc = acc
        self.first = first
        self.groups = groups

    def hop_tensors(self):
        """The tensors a hop of the ring moves: the whole carried state,
        each group's parity included, updated in place by a fold."""
        if self.acc is not None:
            return [self.acc]
        return [g[k] for g in self.groups for k in CARRY_STATE]

    def tensors(self):
        """The device tensors the carry holds (the memory ledger's
        `train.hist_carry`): its state, as a hop moves it."""
        return self.hop_tensors()


def histogram_carry_init(n_rows: int, f: int, slots: torch.Tensor,
                         max_bin: int,
                         lengths: Optional[torch.Tensor] = None
                         ) -> HistCarry:
    """A zero carry of the leaves `slots` [S] i32 over `n_rows` rows of
    `f` features.  On a CUDA device `lengths` [S] i32 holds each slot's
    rows among all N (the carry needs them before the first shard; they
    and the slots are read to the host once, for `carry_height`); the
    pieces are `launch_plan(n_rows, f, s, max_bin)`'s, for each group of
    up to 14 slots as K1 and K2 take them."""
    dev = slots.device
    s = slots.shape[0]
    if slots.dim() != 1 or slots.dtype != torch.int32 or s == 0:
        raise LightGBMError("slots must be [S] int32 with S >= 1")
    if dev.type == "cpu":
        from .histogram import hist_stream_init
        sl = slots.tolist()
        return HistCarry(slots, max_bin, f,
                         acc=hist_stream_init(f, s, max_bin),
                         first=torch.tensor([sl.index(v) for v in sl]))
    if dev.type != "cuda":
        raise LightGBMError(f"no histogram carry kernel for {dev}")
    if lengths is None or lengths.shape != (s,) or \
            lengths.dtype != torch.int32 or lengths.device != dev:
        raise LightGBMError(f"lengths must be [{s}] int32 on {dev}")
    groups = []
    lens, values = torch.stack([lengths, slots]).tolist()
    for c0 in range(0, s, MULTI_CHUNK):
        sg = slots[c0:c0 + MULTI_CHUNK].contiguous()
        k = sg.shape[0]
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        groups.append(dict(
            slots=sg, lengths=lengths[c0:c0 + MULTI_CHUNK].contiguous(),
            plan=launch_plan(max(n_rows, 1), f, k, max_bin),
            lens=lens[c0:c0 + MULTI_CHUNK],
            values=values[c0:c0 + MULTI_CHUNK],
            prefix=torch.zeros((k, f, max_bin, 3), **f32),
            open=torch.zeros((k, f, max_bin, 3), **f32),
            rank=torch.zeros((2, k), **i32),
            pend_bin=torch.zeros((2, k, f, _BATCH), **i32),
            pend_pay=torch.zeros((2, k, _BATCH, 3), **f32),
            parity=torch.zeros(1, **i32)))
    return HistCarry(slots, max_bin, f, groups=groups)


def histogram_carry_update(carry: HistCarry, bins_fm: torch.Tensor,
                           payload: torch.Tensor,
                           leaf_id: torch.Tensor) -> HistCarry:
    """Fold one shard's rows, the next in row order (bins [F, n] u8/u16,
    payload [n, 3] f32, leaf ids [n] i32), into the carry.  CUDA tensors
    launch `csrc/histogram.cu lgbt_histogram_carry` a group (two
    kernels); CPU tensors run `ops/histogram.py hist_stream_update`."""
    global HIST_CARRY_LAUNCHES
    mb = carry.max_bin
    if carry.acc is not None:
        from .histogram import hist_stream_update
        _check(bins_fm, payload, leaf_id, carry.slots[:1], mb)
        hist_stream_update(carry.acc, bins_fm, payload, leaf_id,
                           carry.slots, mb)
        return carry
    dev = bins_fm.device
    if dev.type != "cuda":
        raise LightGBMError(f"no histogram carry kernel for {dev}")
    f, n = bins_fm.shape
    if f != carry.n_features:
        raise LightGBMError(f"the carry holds {carry.n_features} features, "
                            f"the shard {f}")
    for t in (bins_fm, payload, leaf_id):
        if not t.is_contiguous():
            raise LightGBMError("histogram inputs must be contiguous")
    if n == 0:
        return carry
    from ..compiler import _build
    lib = _build.load("histogram")
    for g in carry.groups:
        sg = g["slots"]
        _check(bins_fm, payload, leaf_id, sg, mb)
        k, chunks = sg.shape[0], g["plan"].chunks
        height = carry_height(n, chunks, g["lens"], g["values"])
        scratch = torch.empty(carry_scratch_ints(n, k, f, mb, height),
                              dtype=torch.int32, device=dev)
        rc = _build.on_stream(dev, lambda stream: lib.lgbt_histogram_carry(
            bins_fm.data_ptr(), bins_fm.element_size(), payload.data_ptr(),
            leaf_id.data_ptr(), sg.data_ptr(), n, f, k, mb, chunks, height,
            scratch.data_ptr(),
            carry_sync(dev, stream, carry_sync_ints(n, k, f)),
            g["lengths"].data_ptr(),
            *(g[key].data_ptr() for key in CARRY_STATE[2:]),
            g["prefix"].data_ptr(), g["open"].data_ptr(),
            ctypes.c_void_p(stream)))
        if rc != 0:
            raise LightGBMError(f"histogram carry kernel launch failed: "
                                f"CUDA error {rc}")
        HIST_CARRY_LAUNCHES += 1
    return carry


def histogram_carry_finalize(carry: HistCarry) -> torch.Tensor:
    """[S, F, MB, 3] f32 histograms of the carry's slots, once every row
    has been folded.  On a CUDA device the groups' prefixes, the
    completed pieces summed in index order (K1's `sum_chunks`), with no
    launch (one group: the carry's own tensor); `hist_stream_finalize`
    on the CPU, a repeated slot taking its first occurrence's rows as in
    K1."""
    if carry.acc is not None:
        from .histogram import hist_stream_finalize
        out = hist_stream_finalize(carry.acc, carry.slots.shape[0],
                                   carry.max_bin)
        return out[carry.first]
    outs = [g["prefix"] for g in carry.groups]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _batch_sums_ordered(work_cell, bins, pay, max_bin):
    """Add full batches of 32 rows (bins [n] of one feature, payload [n,
    3], n a multiple of 32 or the piece's last rows) to a piece's cells
    [MB, 3] as K1 does: a batch's rows of one bin summed in lane order
    from +0.0, then the batch sums added to the cell in batch order."""
    pos = np.arange(bins.size)
    batch, lane = pos // _BATCH, pos % _BATCH
    ok = bins < max_bin
    keys, first, gid = np.unique(batch[ok] * max_bin + bins[ok],
                                 return_index=True, return_inverse=True)
    gsum = np.zeros((keys.size, 3), np.float32)
    ln, pv = lane[ok], pay[ok]
    for l_ in range(_BATCH):
        sel = ln == l_
        gsum[gid[sel]] += pv[sel]
    np.add.at(work_cell, keys % max_bin, gsum)


def carry_ordered_init(f: int, s: int, max_bin: int) -> dict:
    """The carry kernel's state for `s` slots on the CPU, in numpy: the
    prefix and the open piece [s, f, max_bin, 3] f32, the ranks [s], the
    open batch's bins [s, f, 32] and payload [s, 32, 3] (its lanes; how
    many hold rows follows from the rank)."""
    return {"prefix": np.zeros((s, f, max_bin, 3), np.float32),
            "open": np.zeros((s, f, max_bin, 3), np.float32),
            "rank": np.zeros(s, np.int64),
            "pend_bin": np.zeros((s, f, _BATCH), np.int64),
            "pend_pay": np.zeros((s, _BATCH, 3), np.float32)}


def carry_ordered_step(state: dict, bins: np.ndarray, pay: np.ndarray,
                       lid: np.ndarray, slots, lengths, chunks: int,
                       max_bin: int) -> None:
    """Fold one shard (bins [F, n], payload [n, 3] f32, leaf ids [n]) of
    the slots `slots` (a list) with `lengths` rows each over all N into
    `state` in place, as `csrc/histogram.cu carry_fold_kernel` does: for
    each slot, every piece its ranks [R0, R1) reach, in index order,
    starts from the open piece's partial (begun before) or from +0.0,
    takes the pending rows and the shard's, adds its full batches
    (`_batch_sums_ordered`) and carries a batch it leaves open; a
    complete piece goes into the prefix (the first piece copied), the
    open one into `open`."""
    n = lid.size
    first = np.full(n, -1, np.int64)        # the first equal slot, or -1
    for k in range(len(slots) - 1, -1, -1):
        first[lid == slots[k]] = k
    for i, slot in enumerate(slots):
        rows = np.flatnonzero(first == slots.index(slot))
        r0 = int(state["rank"][i])
        r1, big_l = r0 + rows.size, int(lengths[i])
        state["rank"][i] = r1
        if r0 >= big_l or rows.size == 0:
            continue                        # the open batch stays as it is
        bounds = piece_bounds(big_l, chunks)
        ca = int(np.searchsorted(bounds, r0, "right")) - 1
        cb = int(np.searchsorted(bounds, min(r1, big_l) - 1, "right")) - 1
        for c in range(ca, cb + 1):
            b0, b1 = int(bounds[c]), int(bounds[c + 1])
            cont = c == ca and r0 > b0      # begun in an earlier shard
            va = r0 - (r0 - b0) % _BATCH if cont else b0
            vb = min(b1, r1)
            kp = r0 - va if cont else 0     # the pending rows
            take = rows[max(va, r0) - r0:vb - r0]
            vbins = np.concatenate([state["pend_bin"][i, :, :kp],
                                    bins[:, take]], axis=1)
            vpay = np.concatenate([state["pend_pay"][i, :kp], pay[take]])
            m = vb - va
            complete = vb == b1
            full = m - m % _BATCH if not complete else m
            part = state["open"][i].copy() if cont else \
                np.zeros_like(state["open"][i])
            for fi in range(bins.shape[0]):
                _batch_sums_ordered(part[fi], vbins[fi, :full], vpay[:full],
                                    max_bin)
            if full < m:                    # the open batch: carried
                state["pend_bin"][i, :, :m - full] = vbins[:, full:]
                state["pend_pay"][i, :m - full] = vpay[full:]
            if complete:
                state["prefix"][i] = part if c == 0 else \
                    state["prefix"][i] + part
            else:
                state["open"][i] = part


def histogram_carry_ordered(bins_fm: torch.Tensor, payload: torch.Tensor,
                            leaf_id: torch.Tensor, slots: torch.Tensor,
                            max_bin: int, cuts) -> torch.Tensor:
    """The carry kernel's sums on the CPU: the rows of `bins_fm` [F, N],
    `payload` and `leaf_id` cut into shards at `cuts` (ascending row
    indices) and folded one shard after the other by the kernel's state
    machine (`carry_ordered_step`); the finalized carry is the prefix.
    Slots go in groups of 14 with `launch_plan(N, F, s, MB)`'s chunks.
    Equal to `histogram_multi_ordered` over all N rows bit for bit: for
    tests and chip_smoke.py."""
    _check(bins_fm, payload, leaf_id, slots[:MULTI_CHUNK], max_bin)
    f, n = bins_fm.shape
    bins = bins_fm.cpu().numpy().astype(np.int64)
    pay = payload.cpu().numpy()
    lid = leaf_id.cpu().numpy()
    edges = [0] + [int(c) for c in cuts if 0 < int(c) < n] + [n]
    outs = []
    sl_all = slots.tolist()
    for c0 in range(0, len(sl_all), MULTI_CHUNK):
        sl = sl_all[c0:c0 + MULTI_CHUNK]
        chunks = launch_plan(max(n, 1), f, len(sl), max_bin).chunks
        lengths = [int((lid == v).sum()) for v in sl]
        state = carry_ordered_init(f, len(sl), max_bin)
        for a, b in zip(edges[:-1], edges[1:]):
            carry_ordered_step(state, bins[:, a:b], pay[a:b], lid[a:b], sl,
                               lengths, chunks, max_bin)
        outs.append(state["prefix"])
    return torch.from_numpy(np.concatenate(outs))
