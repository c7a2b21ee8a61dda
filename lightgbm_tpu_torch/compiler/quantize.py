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

numpy-only — see plan.py.  The bounded tier's `pack_bounded` is not
ported yet.
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
