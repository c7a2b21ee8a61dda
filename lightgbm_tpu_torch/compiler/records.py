"""Self-contained tree records and the serving kernels' launch plans.

The plan's planes (`quantize.py`) keep the JAX package's layout: per
depth bucket, [tiles, TT, NI] node and child words, a per-tile f32
threshold palette and categorical bitset words, with the trees in tile
order.  A walk over them makes three dependent loads a node (node word,
child word, then the palette).  The fused serving kernel
(`csrc/serve.cu`) reads RECORDS instead, derived from those planes at
`refresh`:

  nodes [N, 4] int32   one 16-byte record a node: the node word, the
                       child word, the threshold's f32 bits decoded from
                       the tile's palette (a code >= P decodes to +0.0,
                       as the kernels' one-hot gather gives), and 0
  meta  [T, 4] int32   per tree, in BOOSTING order: its first record,
                       its node count NI (the bucket's padded count,
                       padding slots included), its step bound (the
                       bucket's depth) and its class
  catw  [N, MW] int32  the bitset words beside each record (categorical
                       models only)

Tree t's records are those of plan row `gather_idx[t]` (clamped, as the
accumulation's gather clamps), so the kernel needs no gather index and
never walks a tile's padding trees, and a walk over the records routes
every row, on every plane, corrupted ones included, exactly as the walk
over the planes does.

The launch plans (`forest_plan`, `traverse_plan`, `accumulate_plan`)
decide each kernel's grid, block, chunk and shared memory; they are the
one place that does, and the CUDA entry points check the shared-memory
size they are given against their own layout.  numpy only.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

#: shared memory a launch gets without opting in, and the most a Hopper
#: block can have (232,448 bytes)
SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 227 * 1024
#: blocks a plan aims at: about two an SM of an H100 (132 SMs)
TARGET_BLOCKS = 256
#: most rows a fused row block holds, and threads a block
MAX_ROWS = 256
THREADS = 512
#: most rows a block of a cluster of one holds by default: past 16 a
#: block's walk grows longer than the extra blocks save (`chip_smoke.py`
#: main phase's sweep of launch plans on an H100, PERF.md)
DEFAULT_ROWS = 16
#: (tree, row) pairs a thread walks a chunk
PAIRS = 4
#: (tree, row) cursors a thread walks in lockstep when it has more than
#: one pair a chunk (2 was 4% faster than 1 at 4096 rows, 4 slower)
ILP = 2
#: most blocks of a thread-block cluster that Hopper schedules portably;
#: the fused plan's default (single blocks were faster at every request
#: size in the sweep)
MAX_CLUSTER = 8
CLUSTER = 1
#: the standalone traverse kernel's most rows a block and threads a
#: block; the standalone accumulation's most rows a block
TRAVERSE_ROWS = 64
TRAVERSE_THREADS = 256
ACCUMULATE_ROWS = 32
ACCUMULATE_THREADS = 256


class ForestRecords(NamedTuple):
    """A forest's records (module docstring), in boosting order."""
    nodes: np.ndarray            # [N, 4] int32
    meta: np.ndarray             # [T, 4] int32
    catw: Optional[np.ndarray]   # [N, MW] int32, or None when MW == 0
    mw: int
    ni_max: int


def build_records(plan, cls: Optional[np.ndarray] = None) -> ForestRecords:
    """The records of `plan` (a `CompiledPlan` with its planes packed).
    `cls` is each tree's class for multiclass models ([T] ints, boosting
    order), else None (class 0)."""
    gidx = np.asarray(plan.gather_idx, np.int64)
    t_trees = len(gidx)
    starts = [0]
    for p in plan.planes:
        n_tiles, tt, _ = p["words"].shape
        starts.append(starts[-1] + n_tiles * tt)
    g = np.clip(gidx, 0, starts[-1] - 1)
    bucket = np.searchsorted(np.asarray(starts[1:]), g, side="right")
    ni = np.array([p["words"].shape[2] for p in plan.planes],
                  np.int64)[bucket]
    depth = np.array([p["depth"] for p in plan.planes], np.int64)[bucket]
    first = np.concatenate([[0], np.cumsum(ni)[:-1]]).astype(np.int64)
    n_nodes = int(ni.sum())
    mw = int(plan.planes[0]["catw"].shape[-1]) if "catw" in plan.planes[0] \
        else 0
    nodes = np.zeros((n_nodes, 4), np.int32)
    catw = np.zeros((n_nodes, mw), np.int32) if mw else None
    for bi, p in enumerate(plan.planes):
        sel = np.nonzero(bucket == bi)[0]
        if len(sel) == 0:
            continue
        n_tiles, tt, n_i = p["words"].shape
        local = g[sel] - starts[bi]
        w = p["words"].reshape(-1, n_i)[local]
        k = p["kids"].reshape(-1, n_i)[local]
        pal = p["pal"].view(np.uint32)[local // tt]          # [n, P]
        code = (w & 0xFFFF).astype(np.int64)
        n_pal = pal.shape[1]
        thr = np.take_along_axis(pal, np.minimum(code, n_pal - 1), axis=1)
        thr = np.where(code < n_pal, thr, np.uint32(0))
        at = first[sel][:, None] + np.arange(n_i)[None, :]
        nodes[at, 0] = w
        nodes[at, 1] = k
        nodes[at, 2] = thr.view(np.int32)
        if mw:
            catw[at] = p["catw"].reshape(-1, n_i, mw)[local]
    if cls is None:
        klass = np.zeros(t_trees, np.int64)
    else:
        klass = np.asarray(cls, np.int64)
        if klass.shape != (t_trees,):
            raise ValueError(f"cls names {klass.shape} trees, the plan "
                             f"{t_trees}")
    meta = np.stack([first, ni, depth, klass], axis=1).astype(np.int32)
    return ForestRecords(nodes, meta, catw, mw, int(ni.max()))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class ForestPlan(NamedTuple):
    """One launch of the fused serving kernel (`csrc/serve.cu`).

    The grid is (cluster, row_blocks): a row block of `rows` rows is
    served by `cluster` blocks (a thread-block cluster when > 1), each of
    `threads` threads.  The trees go in chunks of `trees * cluster`;
    block j of a cluster walks `trees` of each chunk for all the row
    block's rows, `ilp` (tree, row) cursors a thread in lockstep, and one
    thread per (row, class) adds the chunk's values in tree order,
    reading the cluster's blocks' shared memory.  `stage`: a chunk's
    records are copied into shared memory by `cp.async`
    (double-buffered) instead of read through L1.  `rows_smem`: the row
    block's rows are copied into shared memory (row stride F | 1)
    instead of read from device memory.  `smem` is the dynamic shared
    memory a block, laid out as `serve_smem_layout`.
    """
    rows: int
    row_blocks: int
    cluster: int
    trees: int
    threads: int
    ilp: int
    stage: bool
    rows_smem: bool
    smem: int

    @property
    def blocks(self) -> int:
        return self.cluster * self.row_blocks

    @property
    def optin(self) -> bool:
        return self.smem > SMEM_DEFAULT

    def branch(self) -> str:
        """The launch branch, for reports: cluster or single block,
        staged or L1 records, rows in shared or device memory."""
        return "/".join(["cluster" if self.cluster > 1 else "single",
                         "staged" if self.stage else "l1",
                         "rows_smem" if self.rows_smem else "rows_global"])


def serve_smem_layout(rows: int, cluster: int, trees: int, n_class: int,
                      f: int, ni_max: int, stage: bool,
                      rows_smem: bool) -> dict:
    """Byte offsets of the fused kernel's shared memory, as
    `csrc/serve.cu serve_layout` computes them: two value buffers
    [trees, rows] f64, the accumulators [ceil(rows / cluster) * K] f64,
    two record buffers [trees * ni_max] of 16 bytes (staged only), the
    rows [rows, F | 1] f32 (rows_smem only); `total` is the size."""
    rs = -(-rows // cluster)
    vals = 0
    acc = vals + _align16(2 * trees * rows * 8)
    recs = acc + _align16(rs * n_class * 8)
    xs = recs + (2 * trees * ni_max * 16 if stage else 0)
    total = xs + (_align16(rows * (f | 1) * 4) if rows_smem else 0)
    return {"vals": vals, "acc": acc, "recs": recs, "xs": xs,
            "total": total}


@functools.lru_cache(maxsize=1024)
def forest_plan(b: int, f: int, t_trees: int, ni_max: int, mw: int,
                n_class: int, *, cluster: Optional[int] = None,
                rows: Optional[int] = None, ilp: Optional[int] = None,
                threads: Optional[int] = None, stage: Optional[bool] = None,
                rows_smem: Optional[bool] = None) -> ForestPlan:
    """The fused kernel's launch over `b` >= 1 rows of `f` features and a
    forest of `t_trees` trees of at most `ni_max` nodes (`mw` bitset
    words a node, `n_class` classes).

    `cluster` (1, 2, 4 or 8, default CLUSTER, cut to the trees): blocks
    a row block.  `rows` (a power of two up to MAX_ROWS, cut to b): rows
    a row block; by default the most, up to DEFAULT_ROWS * cluster, that
    still give TARGET_BLOCKS blocks.
    `threads` (default THREADS) a block, fewer when the chunk has fewer
    pairs; trees a block a chunk: PAIRS pairs a thread.  `ilp`: cursors
    a thread walks together (default ILP, or 1 when a chunk has no more
    pairs than threads).  `stage` (default: off) and
    `rows_smem` (default: on) are requests: when the shared memory would
    pass SMEM_MAX the plan halves the chunk while the records are staged,
    then drops the staging, then the rows, then halves the chunk and the
    rows a block."""
    if b < 1 or t_trees < 1 or ni_max < 1 or n_class < 1 or f < 0:
        raise ValueError(f"no fused launch for b={b}, f={f}, "
                         f"trees={t_trees}, ni_max={ni_max}, K={n_class}")
    cl = CLUSTER if cluster is None else int(cluster)
    if cl < 1 or cl > MAX_CLUSTER or cl & (cl - 1):
        raise ValueError(f"cluster of {cl} blocks: 1, 2, 4 or 8")
    cl = min(cl, _pow2_floor(t_trees))
    if rows is None:
        rows = DEFAULT_ROWS * cl
        while rows > 1 and -(-b // rows) * cl < TARGET_BLOCKS:
            rows //= 2
    elif rows < 1 or rows > MAX_ROWS or rows & (rows - 1):
        raise ValueError(f"{rows} rows a block: a power of two up to "
                         f"{MAX_ROWS}")
    rows = min(rows, _pow2_ceil(b))
    if ilp is not None and ilp not in (1, 2, 4):
        raise ValueError(f"{ilp} cursors a thread: 1, 2 or 4")
    nt = THREADS if threads is None else int(threads)
    if nt < 32 or nt > THREADS or nt % 32:
        raise ValueError(f"{nt} threads a block: a multiple of 32 up to "
                         f"{THREADS}")
    trees = max(1, min(nt * PAIRS // rows, -(-t_trees // cl)))
    want_stage = bool(stage)
    want_rows = True if rows_smem is None else bool(rows_smem)

    def size(rw_, tr, st, rw):
        return serve_smem_layout(rw_, cl, tr, n_class, f, ni_max, st,
                                 rw)["total"]

    while size(rows, trees, want_stage, want_rows) > SMEM_MAX:
        if want_stage and trees > 1:
            trees //= 2
        elif want_stage:
            want_stage = False
        elif want_rows:
            want_rows = False
        elif trees > 1:
            trees //= 2
        elif rows > 1:               # the accumulators of many classes
            rows //= 2
        else:
            raise ValueError(f"no fused launch fits {SMEM_MAX} B for "
                             f"K={n_class}")
    if ilp is None:
        ilp = ILP if trees * rows > nt else 1
    nt = min(nt, -(-trees * rows // 32) * 32)
    return ForestPlan(rows, -(-b // rows), cl, trees, nt, ilp, want_stage,
                      want_rows, size(rows, trees, want_stage, want_rows))


class RowPlan(NamedTuple):
    """One launch of the standalone traverse (`csrc/traverse.cu`, grid
    (tiles, row_blocks)) or accumulation (`csrc/accumulate.cu`, grid
    (row_blocks,)): `rows` rows a block, `threads` threads, `trees`
    trees a chunk (the accumulation), `rows_smem` and `smem` as in
    `ForestPlan`."""
    rows: int
    row_blocks: int
    trees: int
    threads: int
    rows_smem: bool
    smem: int

    @property
    def optin(self) -> bool:
        return self.smem > SMEM_DEFAULT

    def branch(self) -> str:
        return "rows_smem" if self.rows_smem else "rows_global"


@functools.lru_cache(maxsize=1024)
def traverse_plan(b: int, f: int, tt: int, tiles: int = 1, *,
                  rows_smem: Optional[bool] = None) -> RowPlan:
    """The standalone traverse kernel over `b` >= 1 rows of `f` features
    and `tiles` tiles of `tt` trees: grid (tiles, row blocks), the most
    rows a block up to TRAVERSE_ROWS that still give TARGET_BLOCKS
    blocks, the tile's (tree, row) pairs over the block's threads; the
    rows in shared memory when they fit in SMEM_MAX (and `rows_smem` is
    not False)."""
    if b < 1 or tt < 1 or tiles < 1 or f < 0:
        raise ValueError(f"no traverse launch for b={b}, f={f}, tt={tt}, "
                         f"tiles={tiles}")
    rows = TRAVERSE_ROWS
    while rows > 1 and -(-b // rows) * tiles < TARGET_BLOCKS:
        rows //= 2
    rows = min(rows, _pow2_ceil(b))
    threads = min(TRAVERSE_THREADS, -(-tt * rows // 32) * 32)
    smem = _align16(rows * (f | 1) * 4)
    use = smem <= SMEM_MAX and rows_smem is not False
    return RowPlan(rows, -(-b // rows), tt, threads, use,
                   smem if use else 0)


@functools.lru_cache(maxsize=1024)
def accumulate_plan(b: int, t_trees: int, n_class: int) -> RowPlan:
    """The standalone accumulation over `b` >= 1 rows of `t_trees` trees
    and `n_class` classes: the most rows a block up to ACCUMULATE_ROWS
    that still give TARGET_BLOCKS blocks, chunks of PAIRS values a
    thread; shared memory as the fused kernel's without records or
    rows."""
    if b < 1 or n_class < 1 or t_trees < 0:
        raise ValueError(f"no accumulate launch for b={b}, "
                         f"trees={t_trees}, K={n_class}")
    rows = ACCUMULATE_ROWS
    while rows > 1 and -(-b // rows) < TARGET_BLOCKS:
        rows //= 2
    rows = min(rows, _pow2_ceil(b))
    trees = max(1, min(ACCUMULATE_THREADS * PAIRS // rows, t_trees))

    def size(rw_):
        return serve_smem_layout(rw_, 1, trees, n_class, 0, 1, False,
                                 False)["total"]

    while size(rows) > SMEM_MAX:     # the accumulators of many classes
        if rows == 1:
            raise ValueError(f"no accumulate launch fits {SMEM_MAX} B for "
                             f"K={n_class}")
        rows //= 2
        trees = max(1, min(ACCUMULATE_THREADS * PAIRS // rows, t_trees))
    threads = min(ACCUMULATE_THREADS, -(-trees * rows // 32) * 32)
    return RowPlan(rows, -(-b // rows), trees, threads, False, size(rows))
