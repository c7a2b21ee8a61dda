"""The quantized multi-leaf histogram: the K4 kernel's wrapper and plain
version, and the int8 lattice it reads.

The port's counterpart of `lightgbm_tpu/ops/pallas_hist.py`'s K4 entry
points (`quantized_lattice_rows` `:365`,
`pallas_histogram_multi_quantized_rows` `:398`, launcher
`_run_kernel_multi_i8`, kernel `_hist_kernel_multi_i8`).

`quantized_lattice_rows(payload, s_g, s_h)` turns a quantized payload
[N, 3] f32 (gq s_g w, hq s_h w, w) into the lattice pw3 [3, N] int8
(gq, hq, w != 0).  `histogram_multi_quantized(bins_fm, pw3, leaf_id,
slots, max_bin, s_g, s_h)` returns [S, F, MB, 3] f32: cell (s, f, b, c)
is the integer sum of `pw3[c]` over the rows where `leaf_id == slots[s]`
and `bins_fm[f] == b`, converted to f32 and then multiplied by s_g
(c = 0) or s_h (c = 1); the count (c = 2) is not scaled.  Each slot is
matched on its own, as in the reference kernel; a slot that matches no
row gives zeros.

CUDA tensors launch the hand-written kernel `csrc/histogram_q.cu`; CPU
tensors run `histogram_multi_quantized_plain`.  There is no fallback
from one to the other.  The sums are of small integers in int32, exact
in any order, so the kernel, its plain version and the reference's
`pallas_histogram_multi_quantized_rows` and `leaf_histogram_packed_multi`
all give the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.log import LightGBMError
from .hist_kernel import (_MAX_BLOCKS_PER_SM, _SMEM_MAX, _SMS, LaunchPlan,
                          piece_bounds, plan_launch, row_lists_plain,
                          row_scratch_ints, ticket)

#: K4 launches made by `histogram_multi_quantized` (one per chunk of slots)
HIST_Q_LAUNCHES = 0

#: most slots one launch takes (the reference's `MULTI_CHUNK_Q`)
MULTI_CHUNK_Q = 42

#: rows a call may take: every int32 cell stays exact while a row adds at
#: most 15 (|gq| <= 7, hq <= 15 at num_grad_quant_bins <= 15)
MAX_ROWS_Q = (2 ** 31 - 1) // 15

#: the launch plan's cost model for the int32 adds of
#: `csrc/hist_q_common.cuh hist_q_partial_kernel`, used only to pick the
#: chunk count: device time of one 32-row batch of one (slot, feature) on
#: one warp (an estimate, on the low side)
_NS_PER_BATCH_Q = 150.0


def q_smem_bytes(feature_group: int, max_bin: int) -> int:
    """Shared memory of one accumulation block (`hist_q_common.cuh
    q_partial_smem_bytes`): `feature_group` [max_bin, 3] int32
    histograms."""
    return feature_group * max_bin * 12


def q_max_bin_limit() -> int:
    """Largest `max_bin` a launch takes: one feature's histogram a
    block."""
    return _SMEM_MAX // q_smem_bytes(1, 1)


@functools.lru_cache(maxsize=1024)
def launch_plan_q(n: int, f: int, s: int, max_bin: int) -> LaunchPlan:
    """K4's and K5's first stage over `n` >= 1 rows, `f` features and `s`
    <= 42 slots of `max_bin` bins: the grid (s * groups, chunks) of
    `hist_kernel.plan_launch`, for int32 cells of 12 bytes a bin; a block
    adds `feature_group` features (one a warp) of one slot over piece c
    of the slot's listed rows (`hist_kernel.piece_bounds`)."""
    if not 1 <= s <= MULTI_CHUNK_Q:
        raise LightGBMError(f"{s} slots: a launch takes 1 to "
                            f"{MULTI_CHUNK_Q}")
    limit = q_max_bin_limit()
    if max_bin > limit:
        raise LightGBMError(
            f"max_bin {max_bin} needs {q_smem_bytes(1, max_bin)} B of "
            f"shared memory a block; the quantized histogram kernel takes "
            f"max_bin up to {limit} ({_SMEM_MAX} B)")
    return plan_launch(n, f, s, max_bin, q_smem_bytes, _NS_PER_BATCH_Q)


def q_row_scratch_ints(n: int, s: int) -> int:
    """int32 scratch of the row lists: K1's (`row_scratch_ints`) and the
    listed rows' lattice words [n]."""
    return row_scratch_ints(n, s) + n


def q_first_stage_scratch(n: int, s: int, f: int, max_bin: int,
                          chunks: int, device):
    """(scratch, rowbuf pointer, workspace pointer) of one launch: one
    int32 allocation holding the row scratch (`q_row_scratch_ints`) and
    the int32 workspace [chunks, S, F, MB, 3]."""
    rows = q_row_scratch_ints(n, s)
    scratch = torch.empty(rows + chunks * s * f * max_bin * 3,
                          dtype=torch.int32, device=device)
    ptr = scratch.data_ptr()
    return scratch, ptr, ptr + 4 * rows


def quantized_lattice_rows(payload: torch.Tensor, s_g: torch.Tensor,
                           s_h: torch.Tensor, *,
                           debug: bool = False) -> torch.Tensor:
    """[3, N] int8 lattice (round(g / s_g), round(h / s_h), w != 0) of a
    quantized payload [N, 3] f32.  Precondition: w in {0, 1} (the lattice
    binarizes the count channel); `debug` (the booster's
    `tpu_debug_nans`) checks it on the host and raises FloatingPointError
    as the reference does."""
    if debug:
        w = payload[:, 2]
        bad = int(((w != 0.0) & (w != 1.0)).sum())
        if bad:
            raise FloatingPointError(
                f"quantized histogram precondition violated: {bad} "
                "weight(s) outside {0, 1} — the int8 lattice binarizes "
                "the count channel; quantized grads require binary "
                "bagging weights")
    gq = torch.round(payload[:, 0] / s_g).to(torch.int8)
    hq = torch.round(payload[:, 1] / s_h).to(torch.int8)
    w = (payload[:, 2] != 0).to(torch.int8)
    return torch.stack([gq, hq, w])


def dequantize(acc: torch.Tensor, s_g: torch.Tensor,
               s_h: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer sums -> f32 (sum_g * s_g, sum_h * s_h, count), the
    reference wrapper's `astype(f32)` then scale."""
    h = acc.to(torch.float32)
    return torch.stack([h[..., 0] * s_g, h[..., 1] * s_h, h[..., 2]], dim=-1)


def _check_q(bins_fm, pw3, leaf_id, slots, max_bin):
    if bins_fm.dim() != 2 or bins_fm.dtype not in (torch.uint8,
                                                   torch.uint16):
        raise LightGBMError("bins_fm must be [F, N] uint8 or uint16")
    f, n = bins_fm.shape
    if pw3.shape != (3, n) or pw3.dtype != torch.int8:
        raise LightGBMError(f"pw3 must be [3, {n}] int8")
    if leaf_id.shape != (n,) or leaf_id.dtype != torch.int32:
        raise LightGBMError(f"leaf_id must be [{n}] int32")
    if slots.dim() != 1 or slots.dtype != torch.int32 or \
            slots.shape[0] == 0:
        raise LightGBMError("slots must be [S] int32 with S >= 1")
    if max_bin < 1:
        raise LightGBMError(f"max_bin must be positive, got {max_bin}")
    if n > MAX_ROWS_Q:
        raise LightGBMError(f"{n} rows: the int32 lattice sums are exact "
                            f"up to {MAX_ROWS_Q} rows a call")
    if any(t.device != bins_fm.device for t in (pw3, leaf_id, slots)):
        raise LightGBMError("histogram inputs lie on different devices")


def _scales(s_g, s_h, device) -> torch.Tensor:
    """(s_g, s_h) as a [2] f32 tensor on `device`."""
    return torch.stack([torch.as_tensor(s_g, dtype=torch.float32,
                                        device=device).reshape(()),
                        torch.as_tensor(s_h, dtype=torch.float32,
                                        device=device).reshape(())])


def histogram_multi_quantized_plain(bins_fm: torch.Tensor,
                                    pw3: torch.Tensor,
                                    leaf_id: torch.Tensor,
                                    slots: torch.Tensor, max_bin: int,
                                    s_g, s_h) -> torch.Tensor:
    """Plain version: per slot, an int64 `index_add_` of its rows'
    lattice values into (feature, bin) cells, then `dequantize`."""
    _check_q(bins_fm, pw3, leaf_id, slots, max_bin)
    f, n = bins_fm.shape
    dev = bins_fm.device
    vals = pw3.t().to(torch.int64)                           # [N, 3]
    bins = bins_fm.to(torch.int64)       # CUDA cannot index uint16 columns
    offs = torch.arange(f, device=dev, dtype=torch.int64)[:, None] * max_bin
    acc = torch.zeros((slots.shape[0], f * max_bin, 3), dtype=torch.int64,
                      device=dev)
    for i, slot in enumerate(slots.tolist()):
        rows = torch.nonzero(leaf_id == slot).squeeze(1)
        key = (bins[:, rows] + offs).reshape(-1)
        acc[i].index_add_(0, key, vals[rows].repeat(f, 1))
    sc = _scales(s_g, s_h, dev)
    return dequantize(acc.view(-1, f, max_bin, 3), sc[0], sc[1])


def histogram_multi_quantized_pieces(bins_fm: torch.Tensor,
                                     pw3: torch.Tensor,
                                     leaf_id: torch.Tensor,
                                     slots: torch.Tensor, max_bin: int,
                                     s_g, s_h) -> torch.Tensor:
    """The kernel's path on the CPU, for tests: the row lists and lattice
    words of `hist_kernel.row_lists_plain`, each slot's list cut into the
    pieces of `launch_plan_q`'s chunk count, an int64 histogram per piece
    from the listed lattice words alone, the pieces summed, then
    `dequantize`.  Equal to `histogram_multi_quantized_plain` bit for
    bit: integer sums in any order."""
    _check_q(bins_fm, pw3, leaf_id, slots, max_bin)
    f, n = bins_fm.shape
    s = slots.shape[0]
    chunks = launch_plan_q(max(n, 1), f, s, max_bin).chunks
    lists = row_lists_plain(leaf_id, slots, pw3)
    sl = slots.tolist()
    bins = bins_fm.cpu().numpy().astype(np.int64)
    lat = lists.lattice.astype(np.uint32)
    vals = np.stack([((lat >> (8 * c)) & 0xFF).astype(np.uint8)
                     .view(np.int8).astype(np.int64) for c in range(3)], 1)
    acc = np.zeros((s, f, max_bin, 3), np.int64)
    for i, slot in enumerate(sl):
        k = sl.index(slot)                      # a repeat: the first's rows
        a, b = lists.slot_start[k], lists.slot_start[k + 1]
        bounds = a + piece_bounds(b - a, chunks)
        for c in range(bounds.size - 1):
            rows = lists.list[bounds[c]:bounds[c + 1]]
            v = vals[bounds[c]:bounds[c + 1]]
            for fi in range(f):
                bb = bins[fi, rows]
                ok = bb < max_bin
                np.add.at(acc[i, fi], bb[ok], v[ok])
    sc = _scales(s_g, s_h, torch.device("cpu"))
    return dequantize(torch.from_numpy(acc), sc[0], sc[1])


def _launch(bins_fm, pw3, leaf_id, slots, max_bin, scales):
    """One K4 launch over 1 to 42 slots."""
    global HIST_Q_LAUNCHES
    f, n = bins_fm.shape
    s = slots.shape[0]
    dev = bins_fm.device
    out = torch.empty((s, f, max_bin, 3), dtype=torch.float32, device=dev)
    plan = launch_plan_q(n, f, s, max_bin)
    scratch, rowbuf, work = q_first_stage_scratch(n, s, f, max_bin,
                                                  plan.chunks, dev)
    from ..compiler import _build
    lib = _build.load("histogram_q")
    rc = _build.on_stream(dev, lambda stream: lib.lgbt_histogram_q(
        bins_fm.data_ptr(), bins_fm.element_size(), pw3.data_ptr(),
        leaf_id.data_ptr(), slots.data_ptr(), n, f, s, max_bin,
        plan.feature_group, plan.chunks, rowbuf, ticket(dev, stream), work,
        scales.data_ptr(), out.data_ptr(), ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"quantized histogram kernel launch failed: "
                            f"CUDA error {rc}")
    HIST_Q_LAUNCHES += 1
    return out


def histogram_multi_quantized(bins_fm: torch.Tensor, pw3: torch.Tensor,
                              leaf_id: torch.Tensor, slots: torch.Tensor,
                              max_bin: int, s_g, s_h) -> torch.Tensor:
    """[S, F, MB, 3] f32 histograms of the leaves `slots` [S] i32 over
    bins_fm [F, N] u8/u16, the lattice pw3 [3, N] int8 and row leaf ids
    [N] i32, scaled by s_g and s_h (0-d f32 tensors or floats).  The
    slots go in chunks of MULTI_CHUNK_Q = 42: on a CUDA device one launch
    of `csrc/histogram_q.cu` each, on the CPU
    `histogram_multi_quantized_plain`."""
    if bins_fm.device.type == "cpu":
        return histogram_multi_quantized_plain(bins_fm, pw3, leaf_id, slots,
                                               max_bin, s_g, s_h)
    if bins_fm.device.type != "cuda":
        raise LightGBMError(f"no quantized histogram kernel for "
                            f"{bins_fm.device}")
    _check_q(bins_fm, pw3, leaf_id, slots, max_bin)
    for t in (bins_fm, pw3, leaf_id, slots):
        if not t.is_contiguous():
            raise LightGBMError("histogram inputs must be contiguous")
    if bins_fm.shape[0] == 0 or bins_fm.shape[1] == 0:
        raise LightGBMError("the quantized histogram kernel needs rows and "
                            "features")
    scales = _scales(s_g, s_h, bins_fm.device)
    outs = [_launch(bins_fm, pw3, leaf_id, slots[c0:c0 + MULTI_CHUNK_Q],
                    max_bin, scales)
            for c0 in range(0, slots.shape[0], MULTI_CHUNK_Q)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# ---- the carry: one shard's rows added to int32 cells ----------------
#
# The shard-streamed grower folds shard after shard into int32 cells
# carried on the device and dequantizes them once, after the last shard.
# Integer sums do not depend on order, so the finalized carry is
# `histogram_multi_quantized` over all N rows bit for bit, and a shard is
# one launch with no row list (`csrc/histogram_q.cu carry_q_kernel`).

#: carry-kernel launches made by `histogram_carry_q_update` (one a group
#: of up to 42 slots) and `histogram_carry_q_finalize`
HIST_CARRY_Q_LAUNCHES = 0

#: the one-pass carry's plan: the shared memory a block aims at (four
#: blocks an SM), the fewest rows a tile holds (so that summing a tile's
#: cells stays small beside adding its rows), the largest cluster
_CARRY_Q_SMEM = 56 * 1024
_CARRY_Q_MIN_TILE = 4096
_CARRY_Q_CLUSTER = 8


def carry_q_smem_bytes(slot_group: int, feature_group: int,
                       max_bin: int) -> int:
    """Shared memory of one one-pass carry block (`histogram_q.cu
    carry_q_smem_bytes`): the int32 cells [slot_group, feature_group,
    max_bin, 3] and the block's slots."""
    return slot_group * feature_group * max_bin * 12 + 4 * slot_group


class CarryQPlan(NamedTuple):
    """One launch of `carry_q_kernel`: a block adds the rows of one tile
    (`tile_rows` rows; `tiles` of them cover the shard, a multiple of
    `cluster`) for a group of `slot_group` slots and `feature_group`
    features into int32 cells of `smem` bytes; a cluster of `cluster`
    blocks (consecutive tiles) sums its cells before the global adds."""
    slot_group: int
    feature_group: int
    tiles: int
    tile_rows: int
    cluster: int
    smem: int


@functools.lru_cache(maxsize=1024)
def launch_plan_carry_q(n: int, f: int, s: int, max_bin: int) -> CarryQPlan:
    """The one-pass carry's launch over a shard of `n` >= 1 rows, `f`
    features and `s` <= 42 slots of `max_bin` bins.  Slot group: as many
    slots as fit `_CARRY_Q_SMEM` (one if a slot's cells alone need more,
    up to 227 KB), cut evenly.  Feature group: the largest whose blocks,
    with as many tiles as the rows allow (`_CARRY_Q_MIN_TILE` rows each),
    fill the SMs four blocks deep, else one feature.  Tiles: enough for
    that, at most one a `_CARRY_Q_MIN_TILE` rows; the cluster the largest
    power of two up to 8 that the tiles hold, the tiles rounded up to its
    multiple."""
    if not 1 <= s <= MULTI_CHUNK_Q:
        raise LightGBMError(f"{s} slots: a launch takes 1 to "
                            f"{MULTI_CHUNK_Q}")
    limit = q_max_bin_limit()
    if max_bin > limit:
        raise LightGBMError(
            f"max_bin {max_bin} needs {q_smem_bytes(1, max_bin)} B of "
            f"shared memory a block; the quantized histogram carry takes "
            f"max_bin up to {limit} ({_SMEM_MAX} B)")
    cell = carry_q_smem_bytes(1, 1, max_bin)   # one (slot, feature)
    budget = max(_CARRY_Q_SMEM, cell)
    sb = min(s, budget // cell)
    sgroups = -(-s // sb)
    sb = -(-s // sgroups)
    tiles_max = -(-n // _CARRY_Q_MIN_TILE)
    target = _SMS * _MAX_BLOCKS_PER_SM
    for fg in range(min(f, budget // (sb * cell)), 0, -1):
        combos = sgroups * -(-f // fg)
        tiles = min(tiles_max, -(-target // combos))
        if combos * tiles >= target:
            break
    fg = -(-f // -(-f // fg))                 # groups cut evenly
    cluster = 1
    while cluster * 2 <= min(_CARRY_Q_CLUSTER, tiles):
        cluster *= 2
    tile_rows = -(-n // tiles)
    tiles = -(-n // tile_rows)
    tiles = -(-tiles // cluster) * cluster
    return CarryQPlan(sb, fg, tiles, tile_rows, cluster,
                      carry_q_smem_bytes(sb, fg, max_bin))


class QHistCarry:
    """The int32 sums [S, F, MB, 3] of `slots` over the rows folded so
    far (int64 on the CPU, the plain version's)."""

    __slots__ = ("slots", "max_bin", "acc")

    def __init__(self, slots, max_bin, acc):
        self.slots = slots
        self.max_bin = max_bin
        self.acc = acc

    def tensors(self):
        return [self.acc]


def histogram_carry_q_init(f: int, slots: torch.Tensor,
                           max_bin: int) -> QHistCarry:
    """A zero carry of the leaves `slots` [S] i32 over `f` features, on
    the slots' device."""
    dev = slots.device
    if slots.dim() != 1 or slots.dtype != torch.int32 or \
            slots.shape[0] == 0:
        raise LightGBMError("slots must be [S] int32 with S >= 1")
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError(f"no quantized histogram carry kernel for {dev}")
    dtype = torch.int64 if dev.type == "cpu" else torch.int32
    return QHistCarry(slots, max_bin, torch.zeros(
        (slots.shape[0], f, max_bin, 3), dtype=dtype, device=dev))


def histogram_carry_q_update(carry: QHistCarry, bins_fm: torch.Tensor,
                             pw3: torch.Tensor,
                             leaf_id: torch.Tensor) -> QHistCarry:
    """Fold one shard's rows (bins [F, n] u8/u16, lattice pw3 [3, n]
    int8, leaf ids [n] i32) into the carry.  CUDA tensors launch
    `csrc/histogram_q.cu lgbt_histogram_carry_q` (one kernel) a group of
    up to 42 slots; CPU tensors add each slot's rows with an int64
    `index_add_` (`histogram_multi_quantized_plain`'s sums)."""
    global HIST_CARRY_Q_LAUNCHES
    mb = carry.max_bin
    sl = carry.slots
    _check_q(bins_fm, pw3, leaf_id, sl, mb)
    f, n = bins_fm.shape
    if carry.acc.shape[1] != f:
        raise LightGBMError(f"the carry holds {carry.acc.shape[1]} "
                            f"features, the shard {f}")
    dev = bins_fm.device
    if dev.type == "cpu":
        carry_q_plain_update(carry.acc, bins_fm, pw3, leaf_id, sl, mb)
        return carry
    if dev.type != "cuda":
        raise LightGBMError(f"no quantized histogram carry kernel for {dev}")
    for t in (bins_fm, pw3, leaf_id):
        if not t.is_contiguous():
            raise LightGBMError("histogram inputs must be contiguous")
    if n == 0:
        return carry
    from ..compiler import _build
    lib = _build.load("histogram_q")
    for c0 in range(0, sl.shape[0], MULTI_CHUNK_Q):
        sg = sl[c0:c0 + MULTI_CHUNK_Q]
        k = sg.shape[0]
        plan = launch_plan_carry_q(n, f, k, mb)
        dst = carry.acc[c0:c0 + k]
        rc = _build.on_stream(dev, lambda stream: lib.lgbt_histogram_carry_q(
            bins_fm.data_ptr(), bins_fm.element_size(), pw3.data_ptr(),
            leaf_id.data_ptr(), sg.data_ptr(), n, f, k, mb, plan.slot_group,
            plan.feature_group, plan.tiles, plan.tile_rows, plan.cluster,
            dst.data_ptr(), ctypes.c_void_p(stream)))
        if rc != 0:
            raise LightGBMError(f"quantized histogram carry kernel launch "
                                f"failed: CUDA error {rc}")
        HIST_CARRY_Q_LAUNCHES += 1
    return carry


def carry_q_plain_update(acc: torch.Tensor, bins_fm: torch.Tensor,
                         pw3: torch.Tensor, leaf_id: torch.Tensor,
                         slots: torch.Tensor, max_bin: int) -> None:
    """The int32 carry's plain version: each slot's rows of the shard
    `index_add_`ed into the integer sums `acc` [S, F, MB, 3] (int64 on
    the CPU), any device."""
    f = bins_fm.shape[0]
    vals = pw3.t().to(torch.int64)
    bins = bins_fm.to(torch.int64)
    offs = torch.arange(f, dtype=torch.int64,
                        device=bins.device)[:, None] * max_bin
    flat = acc.view(slots.shape[0], f * max_bin, 3)
    for i, slot in enumerate(slots.tolist()):
        rows = torch.nonzero(leaf_id == slot).squeeze(1)
        flat[i].index_add_(0, (bins[:, rows] + offs).reshape(-1),
                           vals[rows].repeat(f, 1).to(acc.dtype))


def histogram_carry_q_finalize(carry: QHistCarry, s_g, s_h) -> torch.Tensor:
    """[S, F, MB, 3] f32: the carried sums dequantized once (K4's
    `dequant_cell` on a CUDA device, `dequantize` on the CPU)."""
    global HIST_CARRY_Q_LAUNCHES
    acc = carry.acc
    dev = acc.device
    sc = _scales(s_g, s_h, dev)
    if dev.type == "cpu":
        return dequantize(acc, sc[0], sc[1])
    from ..compiler import _build
    lib = _build.load("histogram_q")
    out = torch.empty(acc.shape, dtype=torch.float32, device=dev)
    rc = _build.on_stream(dev, lambda stream:
                          lib.lgbt_histogram_carry_q_finalize(
                              acc.data_ptr(), acc.numel(), sc.data_ptr(),
                              out.data_ptr(), ctypes.c_void_p(stream)))
    if rc != 0:
        raise LightGBMError(f"quantized histogram carry finalize failed: "
                            f"CUDA error {rc}")
    HIST_CARRY_Q_LAUNCHES += 1
    return out
