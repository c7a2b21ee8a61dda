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

The stacked traversal (`csrc/stacked.cu`, the device-sum and slot
rungs') reads records of its own, one 16-byte record a node of the
stacked [T, NI] planes (`stacked_records`).

The launch plans (`forest_plan`, `traverse_plan`, `accumulate_plan`,
`stacked_plan`, `bounded_plan`) decide each kernel's grid, block, chunk
and shared memory; they are the one place that does, and the CUDA entry
points check the shared-memory size they are given against their own
layout.  numpy only.
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
#: most row blocks a fused launch's grid holds (its y dimension)
MAX_ROW_BLOCKS = 65535
#: (tree, row) cursors a thread walks in lockstep when it has more than
#: one pair a chunk (2 was 4% faster than 1 at 4096 rows, 4 slower).  The
#: f32 instance (`value_bytes=4`, `device_predict`'s chunks of up to
#: 65,536 rows) walks ILP only while its grid has at most TARGET_BLOCKS
#: blocks, one cursor past that: 16 rows a block of one cursor took
#: 0.2902 ms at 16,384 rows and 1.0804 at 65,536, of two 0.3335 and
#: 1.2886, while at 1024 and 4096 rows (256 blocks) two stay the faster
#: (`chip_smoke.py` predict_api's sweep on an H100, PERF.md).  The rule
#: is keyed on the value size, not on the grid alone, so that every f64
#: plan stays as it was: a serving runtime's batches pass TARGET_BLOCKS
#: blocks under a `serve_max_batch_rows` that is not a power of two
#: (3,000 rows are staged as 3,072: 384 blocks of 8) or above 4096, and
#: the f64 instance was not measured there
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
                      f: int, ni_max: int, stage: bool, rows_smem: bool,
                      value_bytes: int = 8) -> dict:
    """Byte offsets of the fused kernel's shared memory, as
    `csrc/forest_common.cuh layout` computes them: two value buffers
    [trees, rows], the accumulators [ceil(rows / cluster) * K], both at
    `value_bytes` a value (8: the f64 instance, 4: the f32 one), two
    record buffers [trees * ni_max] of 16 bytes (staged only), the rows
    [rows, F | 1] f32 (rows_smem only); `total` is the size."""
    if value_bytes not in (4, 8):
        raise ValueError(f"{value_bytes} bytes a value: 4 or 8")
    rs = -(-rows // cluster)
    vals = 0
    acc = vals + _align16(2 * trees * rows * value_bytes)
    recs = acc + _align16(rs * n_class * value_bytes)
    xs = recs + (2 * trees * ni_max * 16 if stage else 0)
    total = xs + (_align16(rows * (f | 1) * 4) if rows_smem else 0)
    return {"vals": vals, "acc": acc, "recs": recs, "xs": xs,
            "total": total}


@functools.lru_cache(maxsize=1024)
def forest_plan(b: int, f: int, t_trees: int, ni_max: int, mw: int,
                n_class: int, *, cluster: Optional[int] = None,
                rows: Optional[int] = None, ilp: Optional[int] = None,
                threads: Optional[int] = None, stage: Optional[bool] = None,
                rows_smem: Optional[bool] = None,
                value_bytes: int = 8) -> ForestPlan:
    """The fused kernel's launch over `b` >= 1 rows of `f` features and a
    forest of `t_trees` trees of at most `ni_max` nodes (`mw` bitset
    words a node, `n_class` classes).

    `cluster` (1, 2, 4 or 8, default CLUSTER, cut to the trees): blocks
    a row block.  `rows` (a power of two up to MAX_ROWS, cut to b): rows
    a row block; by default the most, up to DEFAULT_ROWS * cluster, that
    still give TARGET_BLOCKS blocks; a request that would make more than
    MAX_ROW_BLOCKS row blocks is refused.
    `threads` (default THREADS) a block, fewer when the chunk has fewer
    pairs; trees a block a chunk: PAIRS pairs a thread.  `ilp`: cursors
    a thread walks together (default ILP, or 1 when a chunk has no more
    pairs than threads, and for the f32 instance also when the grid has
    more than TARGET_BLOCKS blocks).  `stage` (default: off) and
    `rows_smem` (default: on) are requests: when the shared memory would
    pass SMEM_MAX the plan halves the chunk while the records are staged,
    then drops the staging, then the rows, then halves the chunk and the
    rows a block.  `value_bytes`: the instance's value size (8 for
    `lgbt_serve`, 4 for `lgbt_serve_f32`), which sizes its value
    buffers and accumulators."""
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
    if -(-b // rows) > MAX_ROW_BLOCKS:
        raise ValueError(f"{b} rows in blocks of {rows}: more than "
                         f"{MAX_ROW_BLOCKS} row blocks")
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
                                 rw, value_bytes)["total"]

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
        ilp = ILP if trees * rows > nt and (
            value_bytes == 8 or -(-b // rows) * cl <= TARGET_BLOCKS) else 1
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


# ------------------------------------------- the stacked planes' records
#: the stacked record's feature field (bits 0-27); an id outside
#: [0, STACKED_FEAT_OUT) is stored as STACKED_FEAT_OUT, which is >= every
#: row width the kernel takes, so it reads +0.0 as the plain version's
#: out-of-range id does
STACKED_FEAT_OUT = (1 << 28) - 1
#: the stacked traversal's threads a block, most rows a block, most
#: (tree, row) pairs a thread a block, and the blocks its plan aims at
#: (about four an SM): the best of `chip_smoke.py` serve_plane's sweep
#: on an H100 at 1, 256 and 4096 rows (PERF.md)
STACKED_THREADS = 256
STACKED_ROWS = 32
STACKED_PAIRS = 2
STACKED_BLOCKS = 512


def stacked_records(feat: np.ndarray, thr: np.ndarray, dtype: np.ndarray,
                    left: np.ndarray, right: np.ndarray,
                    cat_nwords: Optional[np.ndarray] = None) -> np.ndarray:
    """The [T, NI, 4] int32 records of stacked [T, NI] planes, one
    16-byte record a node, which `csrc/stacked.cu` reads with one vector
    load:

      [0]  the threshold's f32 bits; on a categorical node (decision
           type bit 0, in a model with `cat_nwords`) its bitset's word
           count instead, which is all that node reads
      [1]  left child, [2] right child (int32 as in the planes)
      [3]  bits 0-27 the feature id (STACKED_FEAT_OUT for an id outside
           [0, STACKED_FEAT_OUT)), bit 28 default_left, bits 29-30 the
           missing type, bit 31 is_cat

    Every field the walk reads is kept: the children whole, the decision
    type's three used fields, and the feature id up to what any row's
    width can reach."""
    f = np.asarray(feat, np.int64)
    dt = np.asarray(dtype, np.int64)
    f = np.where((f >= 0) & (f < STACKED_FEAT_OUT), f, STACKED_FEAT_OUT)
    is_cat = ((dt & 1) != 0) if cat_nwords is not None \
        else np.zeros(f.shape, bool)
    word = (f | (((dt >> 1) & 1) << 28) | (((dt >> 2) & 3) << 29)
            | (is_cat.astype(np.int64) << 31))
    thr_bits = np.ascontiguousarray(thr, np.float32).view(np.int32)
    first = thr_bits if cat_nwords is None else np.where(
        is_cat, np.asarray(cat_nwords, np.int32), thr_bits)
    return np.ascontiguousarray(np.stack(
        [first, np.asarray(left, np.int32), np.asarray(right, np.int32),
         word.astype(np.uint32).view(np.int32)], axis=-1))


class StackedPlan(NamedTuple):
    """One launch of the stacked traversal (`csrc/stacked.cu`): grid
    (row_blocks, tree_chunks); a block holds `rows` rows, read from
    device memory, and walks `trees` trees for them, its `threads`
    threads each taking (tree, row) pairs one at a time, lanes on
    neighbouring rows of one tree."""
    rows: int
    row_blocks: int
    trees: int
    tree_chunks: int
    threads: int

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.tree_chunks


@functools.lru_cache(maxsize=1024)
def stacked_plan(b: int, f: int, t_trees: int, *,
                 rows: Optional[int] = None,
                 trees: Optional[int] = None) -> StackedPlan:
    """The stacked traversal over `b` >= 1 rows of `f` features and
    `t_trees` trees.  `rows` (a power of two up to MAX_ROWS, default
    STACKED_ROWS) is cut to the batch.  `trees` a block: by default the
    most up to STACKED_PAIRS pairs a thread that still give the grid
    STACKED_BLOCKS blocks (a 1-row request spreads its trees over the
    SMs, a tree a block)."""
    if b < 1 or t_trees < 1 or f < 0:
        raise ValueError(f"no stacked launch for b={b}, f={f}, "
                         f"trees={t_trees}")
    if rows is None:
        rows = STACKED_ROWS
    elif rows < 1 or rows > MAX_ROWS or rows & (rows - 1):
        raise ValueError(f"{rows} rows a block: a power of two up to "
                         f"{MAX_ROWS}")
    rows = min(rows, _pow2_ceil(b))
    row_blocks = -(-b // rows)
    if trees is None:
        trees = max(1, min(STACKED_THREADS * STACKED_PAIRS // rows,
                           -(-t_trees * row_blocks // STACKED_BLOCKS)))
    elif trees < 1:
        raise ValueError(f"{trees} trees a block")
    trees = min(trees, t_trees)
    threads = min(STACKED_THREADS, -(-min(rows, b) * trees // 32) * 32)
    return StackedPlan(rows, row_blocks, trees, -(-t_trees // trees),
                       threads)


# ------------------------------------------------------- the bounded sum
#: the bounded sum's threads a block and most rows a block: 4 rows of
#: 64 lanes were the best of serve_plane's sweep at 4096 rows on an
#: H100 (16 rows of 16 lanes took 1.4x as long, PERF.md)
BOUNDED_THREADS = 256
BOUNDED_ROWS = 4


class BoundedPlan(NamedTuple):
    """One launch of the bounded sum (`csrc/bounded.cu`): grid
    (row_blocks,); a block holds `rows` rows and `lanes` tree lanes a
    row (`threads` = rows * lanes, thread i on row i % rows, lane
    i / rows), the lanes splitting each (class, tile) group's trees; the
    groups go `group_chunk` at a time, their int32 partials [chunk,
    rows] in shared memory beside the combine's f32 state [K, rows] and
    the chunk's group starts; `smem` the dynamic shared memory a block
    (`bounded_smem`)."""
    rows: int
    row_blocks: int
    lanes: int
    threads: int
    group_chunk: int
    smem: int

    @property
    def optin(self) -> bool:
        return self.smem > SMEM_DEFAULT


def bounded_smem(rows: int, group_chunk: int, n_class: int) -> int:
    """Bytes of the bounded sum's shared memory, as `csrc/bounded.cu`
    lays it out: the partials [group_chunk, rows] int32, the combine
    state [K, rows] f32, then the chunk's group starts [group_chunk + 1]
    int32."""
    return (_align16(group_chunk * rows * 4) + _align16(n_class * rows * 4)
            + _align16((group_chunk + 1) * 4))


@functools.lru_cache(maxsize=1024)
def bounded_plan(b: int, t_trees: int, n_groups: int, n_class: int, *,
                 rows: Optional[int] = None, lanes: Optional[int] = None,
                 group_chunk: Optional[int] = None) -> BoundedPlan:
    """The bounded sum over `b` >= 1 rows, `t_trees` trees in `n_groups`
    (class, tile) groups and `n_class` classes.  `rows` (a power of two
    up to BOUNDED_ROWS): by default the most that still give
    TARGET_BLOCKS blocks, cut to the batch (one row a block below
    TARGET_BLOCKS rows).  `lanes` (a power of two): by default the rest
    of BOUNDED_THREADS, cut to the trees, so a 1-row request spreads
    its trees over a whole block.  The groups' chunk (`group_chunk`,
    default all of them) is halved while the partials would pass
    SMEM_MAX, then the rows are."""
    if b < 1 or t_trees < 1 or n_groups < 1 or n_class < 1:
        raise ValueError(f"no bounded launch for b={b}, trees={t_trees}, "
                         f"groups={n_groups}, K={n_class}")
    if rows is None:
        rows = BOUNDED_ROWS
        while rows > 1 and -(-b // rows) < TARGET_BLOCKS:
            rows //= 2
    elif rows < 1 or rows > BOUNDED_THREADS or rows & (rows - 1):
        raise ValueError(f"{rows} rows a block: a power of two up to "
                         f"{BOUNDED_THREADS}")
    rows = min(rows, _pow2_ceil(b))
    if lanes is None:
        lanes = max(1, min(BOUNDED_THREADS // rows, _pow2_ceil(t_trees)))
    elif lanes < 1 or lanes & (lanes - 1) or rows * lanes > BOUNDED_THREADS:
        raise ValueError(f"{lanes} lanes of {rows} rows: a power of two, "
                         f"at most {BOUNDED_THREADS} threads")
    if group_chunk is not None and group_chunk < 1:
        raise ValueError(f"{group_chunk} groups a chunk")
    chunk = min(n_groups, group_chunk or n_groups)
    while bounded_smem(rows, chunk, n_class) > SMEM_MAX:
        if chunk > 1:
            chunk = -(-chunk // 2)
        elif rows > 1:
            rows //= 2
        else:
            raise ValueError(f"no bounded launch fits {SMEM_MAX} B for "
                             f"K={n_class}")
    return BoundedPlan(rows, -(-b // rows), lanes, rows * lanes, chunk,
                       bounded_smem(rows, chunk, n_class))
