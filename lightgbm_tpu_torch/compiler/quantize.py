"""Node-word packing: each internal node becomes two fused int32 words.

Node word (bit layout, LSB first):

    bits [0:16)   code    — numeric: index into the tile's f32 threshold
                            palette; categorical: the node's bitset word
                            count (the `cat_nwords` of the stacked planes)
    bits [16:28)  feature — 12-bit feature id (plan.py refuses wider)
    bit  28       default_left   (decision_type bit 1)
    bits [29:31)  missing_type   (decision_type bits 2..3)
    bit  31       is_cat         (decision_type bit 0)

Child word: `(left << 16) | (right & 0xFFFF)` — two int16 halves;
negative values are encoded leaves (`~slot`), exactly the stacked
planes' convention, so a kernel step lands on `~slot` and stops.

The threshold "quantization" is a per-tile PALETTE of the distinct f32
threshold bit patterns; the 16-bit code decodes the identical f32 the
stacked `thr` plane carries, so routing through `code -> palette` is
lossless BY CONSTRUCTION — and asserted, never assumed: packing
round-trips every real node's code through the palette and bit-compares
against `np.float32(tree.threshold)`; any mismatch (or a palette past
2^16 entries) raises `PlanNotCompilable`, and the serving runtime
refuses the model.  (Note the palette is keyed on threshold BIT
PATTERNS, not `threshold_bin`: text-loaded models carry zero bins for
numeric nodes until `recompute_threshold_bins`, and serving must not
depend on train-time state.)

The bounded serving tier (`serve_precision=bounded`) extends the same
scheme to leaf VALUES: `pack_bounded` (a copy of the JAX package's
`lightgbm_tpu/compiler/quantize.py:161`) emits per-tile-scaled
int8/int16 leaf-value planes with a worst-case error bound computed at
pack time.  This plane is lossy by design: the bound, not bit parity,
is the published contract, and the serving runtime's probe measures the
real error against it before the rung may serve.

numpy-only — see plan.py.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .plan import MAX_PALETTE, PlanNotCompilable

#: child slots are int16 halves of the kids word
MAX_TILE_NODES = 1 << 15


def _pack_words(code: np.ndarray, feat: np.ndarray,
                dtype_: np.ndarray) -> np.ndarray:
    """Fuse per-node planes into the int32 node word (uint32 math so
    the is_cat bit lands in the sign without overflow warnings)."""
    w = code.astype(np.uint32) & 0xFFFF
    w |= (feat.astype(np.uint32) & 0xFFF) << 16
    dt = dtype_.astype(np.uint32)
    w |= ((dt >> 1) & 1) << 28          # default_left
    w |= ((dt >> 2) & 3) << 29          # missing_type
    w |= (dt & 1) << 31                 # is_cat
    return w.view(np.int32)


def pack_bucket(trees, bucket, mw: int) -> Tuple[Dict, List[Dict]]:
    """Pack one depth bucket's tiles into device-ready numpy planes.

    Returns `(planes, stats)` — planes:
      words [n_tiles, TT, NI] i32, kids [n_tiles, TT, NI] i32,
      pal [n_tiles, P] f32, catw [n_tiles, TT, NI, MW] i32 (cat models
      only; int32 bitcast of the uint32 bitsets — the kernel only
      selects and shifts, never does arithmetic, so the bits survive),
      depth (static int) — the bucket's traversal loop bound.
    Pad tiles/trees get kids == -1 everywhere: the first step routes to
    leaf 0 and parks; their slot rows are never gathered.
    """
    n_tiles = len(bucket.tiles)
    tt = max(len(tile) for tile in bucket.tiles)
    ni = bucket.max_nodes
    if ni >= MAX_TILE_NODES:
        # leaf slots run 0..ni (ni internal nodes have ni+1 leaves) and
        # encode as ~slot, so the kids halves must hold -(ni+1):
        # ni == 32768 would wrap ~32768 to +32767 — an INTERNAL index
        raise PlanNotCompilable(
            f"{ni} nodes per tree exceeds the kids word's int16 halves")

    words = np.zeros((n_tiles, tt, ni), np.int32)
    # pack_rshift: all-pad kids (-1 = leaf 0) so unfilled slots terminate
    kids = np.full((n_tiles, tt, ni), (-1 << 16) | 0xFFFF, np.int32)
    catw = np.zeros((n_tiles, tt, ni, mw), np.uint32) if mw else None

    pals: List[np.ndarray] = []
    stats: List[Dict] = []
    for ti, tile in enumerate(bucket.tiles):
        # ---- tile palette: distinct f32 threshold bit patterns
        thr_bits: List[np.ndarray] = [np.zeros(0, np.uint32)]
        for i in tile:
            t = trees[i]
            k = max(t.num_leaves - 1, 0)
            if k:
                num = (t.decision_type[:k] & 1) == 0
                thr_bits.append(np.float32(t.threshold[:k])[num]
                                .view(np.uint32))
        pal_bits = np.unique(np.concatenate(thr_bits))
        if len(pal_bits) == 0:
            pal_bits = np.zeros(1, np.uint32)
        if len(pal_bits) > MAX_PALETTE:
            raise PlanNotCompilable(
                f"tile palette of {len(pal_bits)} thresholds exceeds "
                f"the node word's 16-bit code field")

        nodes = 0
        for j, i in enumerate(tile):
            t = trees[i]
            k = max(t.num_leaves - 1, 0)
            nodes += max(k, 1)
            if k == 0:
                continue        # single leaf: the all-pad kids row routes
            dt = t.decision_type[:k].astype(np.int32)
            is_cat = (dt & 1) != 0
            bits = np.float32(t.threshold[:k]).view(np.uint32)
            code = np.searchsorted(pal_bits, bits).astype(np.int64)
            # losslessness: decode every numeric code and bit-compare
            if not np.array_equal(pal_bits[code[~is_cat]], bits[~is_cat]):
                raise PlanNotCompilable(
                    "threshold palette round-trip mismatch")
            if np.any(is_cat):
                nw = np.zeros(k, np.int64)
                for nd in np.nonzero(is_cat)[0]:
                    cb = int(t.threshold_bin[nd])
                    lo = int(t.cat_boundaries[cb])
                    hi = int(t.cat_boundaries[cb + 1])
                    nw[nd] = hi - lo
                    catw[ti, j, nd, :hi - lo] = t.cat_threshold[lo:hi]
                code = np.where(is_cat, nw, code)
            words[ti, j, :k] = _pack_words(code, t.split_feature[:k], dt)
            left = t.left_child[:k].astype(np.int32)
            right = t.right_child[:k].astype(np.int32)
            kids[ti, j, :k] = (left << 16) | (right & 0xFFFF)

        pals.append(pal_bits)
        stats.append({
            "depth": int(bucket.depth), "trees": len(tile),
            "nodes": int(nodes), "palette": int(len(pal_bits)),
            "bytes": int(tt * ni * 8 + len(pal_bits) * 4
                         + (tt * ni * mw * 4 if mw else 0)),
        })

    p = max(len(pb) for pb in pals)
    pal = np.zeros((n_tiles, p), np.uint32)
    for ti, pb in enumerate(pals):
        pal[ti, :len(pb)] = pb

    planes: Dict = {"words": words, "kids": kids,
                    "pal": pal.view(np.float32),
                    "depth": int(bucket.depth)}
    if mw:
        planes["catw"] = catw.view(np.int32)
    return planes, stats


def pack_bounded(trees, plan, leaf_values: np.ndarray, num_class: int,
                 bits: int = 8) -> Dict:
    """Quantize the f64 leaf-value table into per-tile-scaled integer
    codes plus a worst-case max-abs-error bound (the bounded serving
    rung's published contract).

    Per tile t the scale is `max|leaf value in t| / qmax` (stored f32 —
    the combine multiplies in f32, so the bound must be computed
    against the f32 scale actually used, not the f64 ideal).  Codes are
    round-to-nearest, clipped to ±qmax.  The bound is, per class, the
    SUM over that class's trees of the tree's measured max per-leaf
    representation error (each row gathers exactly one leaf per tree),
    plus a conservative slop term for the f32 combine arithmetic:
    int32 partials cast exactly to f32 under the `qmax *
    trees_per_tile_class < 2^24` guard (refused otherwise), leaving one
    rounding per `partial * scale` product and per addition of the
    S-term ascending-tile sum — bounded by `4 * (S + 1) * 2^-24 *
    max_k Σ_t scale_t * qmax * n_trees(t, k)`.

    Returns planes in BOOSTING order (aligned with the exact ladder's
    `leaf_values` layout, so the same gathered slots index them):
      qval         [T, NL] int8/int16 leaf codes
      tile_of_tree [T] i32 global tile index (plan bucket/tile order)
      scales       [S] f32 per-tile scales
      bound        float   worst-case |bounded_f32 - exact_f64| on raw
                           scores, any row, any class
      bits, n_tiles, bytes — plane accounting (`device_bytes`).

    Raises `PlanNotCompilable` for configurations outside the format
    (bad bit width, non-finite leaf values, partial-overflow guard); the
    serving runtime then serves its exact rung and counts
    `serve.bounded_disabled{cause=format}`.
    """
    if bits not in (8, 16):
        raise PlanNotCompilable(
            f"serve_quant_bits must be 8 or 16, got {bits}")
    qmax = (1 << (bits - 1)) - 1
    dtype = np.int8 if bits == 8 else np.int16
    t_trees, nl = leaf_values.shape
    if not np.all(np.isfinite(leaf_values)):
        raise PlanNotCompilable(
            "non-finite leaf values cannot be bounded-quantized")

    tiles = [tile for bucket in plan.buckets for tile in bucket.tiles]
    n_tiles = len(tiles)
    tile_of_tree = np.full(t_trees, -1, np.int32)
    scales = np.zeros(n_tiles, np.float32)
    qval = np.zeros((t_trees, nl), dtype)
    tree_err = np.zeros(t_trees, np.float64)
    for s, tile in enumerate(tiles):
        vmax = 0.0
        for i in tile:
            k = max(int(trees[i].num_leaves), 1)
            vmax = max(vmax, float(np.max(np.abs(leaf_values[i, :k]))))
        # all-zero tiles quantize to all-zero codes under scale 1.0
        # (zero error); the f32 cast is what the combine really uses
        scale = np.float32(vmax / qmax) if vmax > 0.0 else np.float32(1.0)
        if not np.isfinite(scale) or float(scale) == 0.0:
            raise PlanNotCompilable(
                f"tile {s}: degenerate quantization scale {scale!r}")
        scales[s] = scale
        for i in tile:
            tile_of_tree[i] = s
            k = max(int(trees[i].num_leaves), 1)
            v = leaf_values[i, :k]
            q = np.clip(np.rint(v / np.float64(scale)), -qmax, qmax)
            qval[i, :k] = q.astype(dtype)
            tree_err[i] = float(np.max(np.abs(v - np.float64(scale) * q)))
    if np.any(tile_of_tree < 0):
        raise AssertionError("bounded packer missed a tree")  # impossible

    # int32 partial -> f32 cast must be exact at the combine: the
    # per-(tile, class) sum of codes is bounded by qmax * member count
    counts = np.zeros((n_tiles, num_class), np.int64)
    for i in range(t_trees):
        counts[tile_of_tree[i], i % num_class] += 1
    if int(np.max(counts, initial=0)) * qmax >= (1 << 24):
        raise PlanNotCompilable(
            f"tile of {int(np.max(counts))} same-class trees at qmax "
            f"{qmax} overflows the exact-f32 range of int32 partials")

    per_class = np.zeros(num_class, np.float64)
    for i in range(t_trees):
        per_class[i % num_class] += tree_err[i]
    amax = (scales.astype(np.float64)[:, None] * qmax * counts).sum(axis=0)
    slop = 4.0 * (n_tiles + 1) * 2.0 ** -24 * amax
    bound = float(np.max(per_class + slop))
    return {"qval": qval, "tile_of_tree": tile_of_tree, "scales": scales,
            "bound": bound, "bits": int(bits), "n_tiles": int(n_tiles),
            "bytes": int(qval.nbytes + tile_of_tree.nbytes
                         + scales.nbytes)}
