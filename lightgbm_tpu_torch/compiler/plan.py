"""Tile planner: depth-bucketed greedy bin-packing of trees into tiles.

The unit of kernel work is a TILE: a group of trees whose packed node
planes (quantize.py) fit the per-tile byte budget together, so one
kernel block reads one tile and traverses every tree in it for a
whole row block (ref: arXiv:2011.02022 "Booster" treats the
trained ensemble as a compilation target — reorder + pack trees so
traversal runs out of fast local memory; the reference CPU walk has no
analogous layer).

Two-level grouping:

 1. DEPTH BUCKETS — trees are first grouped by their max root-to-leaf
    path length rounded up to a power of two.  Every tile in a bucket
    shares the bucket's bound as its single static traversal loop
    count, so a 3-deep stump never pays a 64-step unrolled walk just
    because one late tree went deep (leaf-wise growth makes depth
    heavy-tailed).
 2. TILES — within a bucket, greedy first-fit-decreasing bin packing
    by node count under `tile_vmem_kb` (the packed planes' bytes:
    2 int32 words per node + the f32 threshold palette + categorical
    bitset words).  A tree larger than the budget still gets its own
    tile — a tree is atomic.

Tiling REORDERS trees; the f64 leaf accumulation must stay in boosting
order to be bit-identical (software binary64 addition is not
associative).  The plan records `perm` (compiled position -> original
tree index) and `gather_idx` — for each ORIGINAL tree index, the row in
the kernel's stacked slot output — so the runtime gathers slots back to
boosting order before the exact adder ever sees them.

numpy-only: a copy of the JAX package's planner, minus its telemetry
hook, so the port imports nothing of that package.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

#: feature ids ride in 12 bits of the node word (quantize.py)
MAX_PLAN_FEATURES = 1 << 12
#: bin codes / palette indices / cat word counts ride in 16 bits
MAX_PALETTE = 1 << 16


class PlanNotCompilable(ValueError):
    """The model cannot be expressed in the packed plan format (too many
    features, palette overflow, ambiguous bin codes, linear trees...).
    The port's serving runtime re-raises it as a `LightGBMError`: it has
    no lower rung to fall back to."""


def _tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """Max root-to-leaf path length in INTERNAL-node steps (= the
    traversal loop bound: one more step drives the cursor negative).
    Iterative DFS — leaf-wise trees can be deeper than Python's
    recursion limit is worth trusting."""
    if len(left) == 0:
        return 1
    best = 1
    stack = [(0, 1)]
    while stack:
        nd, d = stack.pop()
        best = max(best, d)
        for child in (int(left[nd]), int(right[nd])):
            if child >= 0:
                stack.append((child, d + 1))
    return best


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


class TileBucket:
    """All tiles sharing one static traversal depth bound."""

    __slots__ = ("depth", "tiles", "max_nodes", "palettes")

    def __init__(self, depth: int):
        self.depth = depth
        self.tiles: List[List[int]] = []     # original tree indices
        self.max_nodes = 1
        self.palettes: List[Dict] = []       # per tile, filled by quantize


class CompiledPlan:
    """Host-side execution plan; quantize.py fills the packed planes.

    Attributes (after `build_plan`):
      buckets     — List[TileBucket], ascending depth.
      perm        — [T] i32: original tree index at each compiled slot
                    (buckets/tiles flattened in order, pads skipped).
      gather_idx  — [T] i32: for original tree i, its row in the
                    flattened kernel slot output (the inverse
                    permutation the accumulation gather uses).
      planes      — per bucket, dict of packed numpy planes
                    (quantize.pack_bucket).
      tile_vmem_kb, n_trees, num_class, tile_stats.
    """

    def __init__(self, tile_vmem_kb: float):
        self.tile_vmem_kb = float(tile_vmem_kb)
        self.buckets: List[TileBucket] = []
        self.perm: Optional[np.ndarray] = None
        self.gather_idx: Optional[np.ndarray] = None
        self.planes: List[Dict] = []
        self.n_trees = 0
        self.num_class = 1
        self.tile_stats: List[Dict] = []

    # ----------------------------------------------------------- summary
    def total_plane_bytes(self) -> int:
        return sum(int(v.nbytes) for pl in self.planes
                   for v in pl.values() if hasattr(v, "nbytes"))

    def num_tiles(self) -> int:
        return sum(len(b.tiles) for b in self.buckets)


def _tile_bytes(n_trees: int, max_nodes: int, pal_entries: int,
                mw: int) -> int:
    """Packed-plane bytes of one tile: node word + child word (int32
    each) for every padded node slot, the f32 threshold palette, and —
    for categorical models — the per-node bitset words."""
    node = n_trees * max_nodes * 8
    pal = pal_entries * 4
    cat = n_trees * max_nodes * mw * 4 if mw else 0
    return node + pal + cat


def build_plan(export: Dict, tile_vmem_kb: float = 512.0,
               name: str = "default") -> CompiledPlan:
    """Plan + quantize an `export_predict_arrays` dict into a
    `CompiledPlan` (raises `PlanNotCompilable` for models outside the
    packed format).  `name` labels the plan for callers' logs; the
    port has no telemetry plane yet."""
    from .quantize import pack_bucket

    trees = export.get("trees") or []
    if not trees:
        raise PlanNotCompilable("no trees to compile")
    if export.get("stacked") is None:
        raise PlanNotCompilable("linear trees serve host-side only")
    if export.get("average_factor", 1) != 1:
        raise PlanNotCompilable(
            "random-forest averaging needs f64 division on device")
    nfeat = max((int(np.max(t.split_feature[:max(t.num_leaves - 1, 0)]))
                 for t in trees if t.num_leaves > 1), default=-1) + 1
    if nfeat > MAX_PLAN_FEATURES:
        raise PlanNotCompilable(
            f"{nfeat} features exceed the node word's 12-bit feature "
            f"field ({MAX_PLAN_FEATURES})")

    plan = CompiledPlan(tile_vmem_kb)
    plan.n_trees = len(trees)
    plan.num_class = int(export.get("num_class", 1))
    budget = max(int(tile_vmem_kb * 1024), 1)

    # model-wide categorical word width (0 = numerical-only fast path)
    mw = 0
    for t in trees:
        if t.num_cat > 0 and len(t.cat_boundaries) > 1:
            mw = max(mw, int(np.max(np.diff(t.cat_boundaries))))
    if mw >= MAX_PALETTE:
        raise PlanNotCompilable(
            f"categorical bitset of {mw} words exceeds the node "
            f"word's 16-bit code field")

    # ---- depth buckets (pow2 so the static loop-bound set stays small)
    depths = [_tree_depth(t.left_child[:max(t.num_leaves - 1, 0)],
                          t.right_child[:max(t.num_leaves - 1, 0)])
              for t in trees]
    by_depth: Dict[int, List[int]] = {}
    for i, d in enumerate(depths):
        by_depth.setdefault(_next_pow2(d), []).append(i)

    # ---- greedy first-fit-decreasing bin packing per bucket
    for depth in sorted(by_depth):
        bucket = TileBucket(depth)
        members = sorted(by_depth[depth],
                         key=lambda i: (-max(trees[i].num_leaves - 1, 1),
                                        i))
        sizes: List[List[int]] = []     # per tile: [n_trees, max_nodes,
        pals: List[int] = []            #           pal upper bound]
        for i in members:
            ni = max(trees[i].num_leaves - 1, 1)
            placed = False
            for ti, (nt, mx, ps) in enumerate(sizes):
                est = _tile_bytes(nt + 1, max(mx, ni), pals[ti] + ni, mw)
                if est <= budget:
                    bucket.tiles[ti].append(i)
                    sizes[ti] = [nt + 1, max(mx, ni), ps + ni]
                    pals[ti] += ni
                    placed = True
                    break
            if not placed:
                bucket.tiles.append([i])
                sizes.append([1, ni, ni])
                pals.append(ni)
            bucket.max_nodes = max(bucket.max_nodes, ni)
        # stable within-tile order: boosting order (FFD sorted by size —
        # restore ascending tree index so debugging reads naturally)
        for tile in bucket.tiles:
            tile.sort()
        plan.buckets.append(bucket)

    # ---- permutation + inverse (the accumulation gather)
    perm: List[int] = []
    flat_pos = np.full(len(trees), -1, np.int32)
    pos = 0
    for bucket in plan.buckets:
        tt = max(len(tile) for tile in bucket.tiles)
        for tile in bucket.tiles:
            for j in range(tt):
                if j < len(tile):
                    perm.append(tile[j])
                    flat_pos[tile[j]] = pos
                pos += 1            # padded slots advance the row count
    plan.perm = np.asarray(perm, np.int32)
    plan.gather_idx = flat_pos
    if np.any(flat_pos < 0) or len(perm) != len(trees):
        raise AssertionError("tile planner dropped a tree")  # impossible

    # ---- pack every bucket's planes (quantize.py asserts losslessness)
    for bucket in plan.buckets:
        planes, stats = pack_bucket(trees, bucket, mw)
        plan.planes.append(planes)
        plan.tile_stats.extend(stats)

    return plan


def plan_summary(plan: CompiledPlan) -> Dict:
    """JSON-ready description of a plan (the compile-plan CLI's body):
    per-tile tree lists, node-word counts, palette sizes and VMEM bytes,
    plus the tree permutation."""
    return {
        "trees": plan.n_trees,
        "num_class": plan.num_class,
        "tile_vmem_kb": plan.tile_vmem_kb,
        "tiles": plan.num_tiles(),
        "buckets": [
            {"depth": b.depth,
             "tiles": [list(map(int, t)) for t in b.tiles]}
            for b in plan.buckets],
        "tile_stats": plan.tile_stats,
        "total_plane_bytes": plan.total_plane_bytes(),
        "permutation": plan.perm.tolist() if plan.perm is not None else [],
    }
