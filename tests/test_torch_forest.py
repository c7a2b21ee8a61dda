"""The fused serving path's records, plain version and launch plans, on
the CPU.

The records (`compiler/records.py`) must be the plan's planes field by
field, bitwise, padding slots included; the fused plain version
(`compiler/kernel.py serve_forest_plain`), which reads the records as
the CUDA kernel does, must be bitwise the JAX package's
`compiled_predict` with the Pallas traverse in interpret mode, on every
family and on corrupted planes; its chunked ordered sum bitwise
`accumulate_slots_exact_plain` at any chunk; and the launch plans must
stay within the card's limits and give every (tree, row) pair and every
(row, class) sum to exactly one thread.  The CUDA kernels are held to
these plain versions on the card by chip_smoke.py.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from lightgbm_tpu.compiler.kernel import \
    compiled_predict as jax_compiled_predict  # noqa: E402
from lightgbm_tpu_torch.compiler import build_plan  # noqa: E402
from lightgbm_tpu_torch.compiler import records as R  # noqa: E402
from lightgbm_tpu_torch.compiler.kernel import (  # noqa: E402
    DeviceRecords, compiled_predict, serve_forest, serve_forest_plain,
    traverse_bucket_plain)
from lightgbm_tpu_torch.ops.predict import \
    accumulate_slots_exact_plain  # noqa: E402
from lightgbm_tpu_torch.serving.runtime import ServingRuntime  # noqa: E402
from test_torch_compiler import (FAMILIES, TILE_KB, _batch,  # noqa: E402
                                 _corrupt, _flush_subnormals, _pair)

CORRUPTIONS = ("child", "cursor", "feature", "palette")


def _plan_and_records(bp, corrupt=None):
    ex = bp.export_predict_arrays()
    plan = build_plan(ex, tile_vmem_kb=TILE_KB)
    if corrupt is not None:
        plan.planes[0] = _corrupt({k: v.copy() if isinstance(v, np.ndarray)
                                   else v for k, v in plan.planes[0].items()},
                                  corrupt)
    cls = ex["stacked"].get("cls")
    rec = R.build_records(plan, None if cls is None else cls.numpy())
    return ex, plan, rec


def _jax_raw(bj, plan, x):
    """The JAX package's compiled program over `plan`'s planes (the
    Pallas traverse in interpret mode): raw f64 sums."""
    exj = bj.export_predict_arrays()
    planes, meta = [], []
    for p in plan.planes:
        catw = p.get("catw")
        planes.append((jnp.asarray(p["words"]), jnp.asarray(p["kids"]),
                       jnp.asarray(p["pal"]),
                       None if catw is None else jnp.asarray(catw)))
        meta.append((p["depth"], catw.shape[-1] if catw is not None else 0))
    K = exj["num_class"]
    hi, lo = jax_compiled_predict(
        jnp.asarray(x), tuple(planes), jnp.asarray(plan.gather_idx),
        exj["value_hi"], exj["value_lo"], exj["stacked"].get("cls"),
        meta=tuple(meta), n_class=K, interpret=True)
    bits = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64))
    return bits.view(np.float64)


def _assert_bits(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float64
    assert np.array_equal(a.view(np.uint64), b.view(np.uint64))


@pytest.mark.parametrize(
    "name,corrupt", [(n, None) for n in FAMILIES]
    + [(n, k) for n in ("binary", "synthetic") for k in CORRUPTIONS])
def test_records_are_the_planes_bitwise(name, corrupt):
    _, bp = _pair(name)
    ex, plan, rec = _plan_and_records(bp, corrupt)
    T = len(plan.gather_idx)
    assert rec.meta.shape == (T, 4) and rec.meta.dtype == np.int32
    assert rec.nodes.dtype == np.int32 and rec.nodes.shape[1] == 4
    # the planes' rows in plan order, with the original tree each holds
    # (None for a tile's padding trees)
    rows, holds = [], []
    for bucket, p in zip(plan.buckets, plan.planes):
        n_tiles, tt, ni = p["words"].shape
        for tile in range(n_tiles):
            for j in range(tt):
                rows.append((p, tile, j))
                members = bucket.tiles[tile]
                holds.append(members[j] if j < len(members) else None)
    first = 0
    for t in range(T):
        # boosting order: record tree t is the plan row holding tree t
        assert holds[plan.gather_idx[t]] == t
        p, tile, j = rows[plan.gather_idx[t]]
        ni = p["words"].shape[2]
        m = rec.meta[t]
        assert (m[0], m[1], m[2]) == (first, ni, p["depth"])
        nodes = rec.nodes[first:first + ni]
        assert np.array_equal(nodes[:, 0], p["words"][tile, j])
        assert np.array_equal(nodes[:, 1], p["kids"][tile, j])
        code = p["words"][tile, j] & 0xFFFF
        pal = p["pal"][tile].view(np.uint32)
        for nd in range(ni):        # padding slots included
            want = pal[code[nd]] if code[nd] < len(pal) else 0
            assert nodes[nd, 2].view(np.uint32) == want
        assert np.all(nodes[:, 3] == 0)
        if "catw" in p:
            assert np.array_equal(rec.catw[first:first + ni],
                                  p["catw"][tile, j])
        first += ni
    assert first == rec.nodes.shape[0]
    K = ex["num_class"]
    if K > 1:
        assert np.array_equal(rec.meta[:, 3], ex["stacked"]["cls"].numpy())
        assert set(rec.meta[:, 3]) == set(range(K))
    else:
        assert np.all(rec.meta[:, 3] == 0)
    assert rec.mw == (plan.planes[0]["catw"].shape[-1]
                      if "catw" in plan.planes[0] else 0)
    assert rec.ni_max == max(p["words"].shape[2] for p in plan.planes)
    if corrupt == "palette":
        assert np.any(rec.nodes[:, 2] == 0)


def test_records_clamp_gather_idx_and_cls_length():
    _, bp = _pair("binary")
    ex, plan, rec = _plan_and_records(bp)
    plan.gather_idx = plan.gather_idx.copy()
    n_rows = sum(p["words"].shape[0] * p["words"].shape[1]
                 for p in plan.planes)
    plan.gather_idx[0] = n_rows + 5          # clamps to the last row
    again = R.build_records(plan)
    last = plan.planes[-1]
    ni = last["words"].shape[2]
    assert np.array_equal(again.nodes[:ni, 0], last["words"][-1, -1])
    with pytest.raises(ValueError, match="cls"):
        R.build_records(plan, np.zeros(3))


@pytest.mark.parametrize("name", FAMILIES)
def test_fused_plain_matches_jax_compiled_predict(name):
    bj, bp = _pair(name)
    # XLA's CPU compares flush f32 subnormals (test_torch_compiler):
    # both sides see the flushed rows
    x = _flush_subnormals(_batch(bp))
    ex, plan, rec = _plan_and_records(bp)
    want = _jax_raw(bj, plan, x)
    drec = DeviceRecords.of(rec, "cpu")
    K = ex["num_class"]
    got = serve_forest_plain(torch.from_numpy(x), drec, ex["value_f64"], K)
    _assert_bits(got.numpy(), want)
    # the wrapper on a CPU tensor is the plain version; so is the
    # compiled program given the records, and without them (traverse
    # per bucket, then the standalone sum) it gives the same bits
    _assert_bits(serve_forest(torch.from_numpy(x), drec, ex["value_f64"],
                              K).numpy(), want)
    planes = [tuple(None if p.get(k) is None else torch.from_numpy(p[k])
                    for k in ("words", "kids", "pal", "catw"))
              for p in plan.planes]
    meta = [(p["depth"], p["catw"].shape[-1] if "catw" in p else 0)
            for p in plan.planes]
    cls = ex["stacked"].get("cls")
    gidx = torch.from_numpy(plan.gather_idx)
    for records in (drec, None):
        _assert_bits(compiled_predict(
            torch.from_numpy(x), planes, gidx, ex["value_f64"], cls,
            meta=meta, n_class=K, records=records).numpy(), want)


@pytest.mark.parametrize("kind", CORRUPTIONS)
@pytest.mark.parametrize("name", ["binary", "synthetic"])
def test_fused_plain_matches_jax_on_corrupted_planes(name, kind):
    bj, bp = _pair(name)
    x = _flush_subnormals(_batch(bp))
    ex, plan, rec = _plan_and_records(bp, kind)
    want = _jax_raw(bj, plan, x)
    got = serve_forest_plain(torch.from_numpy(x),
                             DeviceRecords.of(rec, "cpu"), ex["value_f64"],
                             ex["num_class"])
    _assert_bits(got.numpy(), want)
    _, clean_plan, clean = _plan_and_records(bp)
    assert not np.array_equal(_jax_raw(bj, clean_plan, x), want), \
        "corruption had no effect"


@pytest.mark.parametrize("name", ["regression_l2", "multiclass",
                                  "categorical"])
def test_chunked_ordered_sum_is_the_plain_accumulation(name):
    _, bp = _pair(name)
    x = torch.from_numpy(_batch(bp))
    ex, plan, rec = _plan_and_records(bp)
    K = ex["num_class"]
    slots = torch.cat([traverse_bucket_plain(
        x, torch.from_numpy(p["words"]), torch.from_numpy(p["kids"]),
        torch.from_numpy(p["pal"]),
        torch.from_numpy(p["catw"]) if "catw" in p else None, p["depth"],
        p["catw"].shape[-1] if "catw" in p else 0) for p in plan.planes])
    want = accumulate_slots_exact_plain(
        slots, torch.from_numpy(plan.gather_idx), ex["value_f64"], K,
        ex["stacked"].get("cls")).numpy()
    drec = DeviceRecords.of(rec, "cpu")
    T = rec.meta.shape[0]
    for chunk in (1, 7, T):
        got = serve_forest_plain(x, drec, ex["value_f64"], K, chunk=chunk)
        _assert_bits(got.numpy(), want)


def test_runtime_serves_through_the_records():
    _, bp = _pair("multiclass")
    rt = ServingRuntime(bp, device="cpu", tile_vmem_kb=TILE_KB)
    st_ = rt._state
    assert st_.records.meta.shape[0] == len(st_.plan.gather_idx)
    X = np.random.RandomState(0).randn(40, bp.num_feature())
    got = rt.predict(X, raw_score=True)
    Xd = rt._stage32(X, rt._chunk_rows(40))
    ex = st_.export
    unfused = compiled_predict(Xd, st_.planes, st_.gidx, ex["value_f64"],
                               st_.cls, meta=st_.meta, n_class=3)[:40]
    _assert_bits(got, unfused.numpy())
    _assert_bits(got, bp.predict(X, raw_score=True))


# ------------------------------------------------------------ launch plans
def _check_forest_plan(plan, b, f, t, ni_max, mw, k, value_bytes=8):
    assert 1 <= plan.cluster <= R.MAX_CLUSTER
    assert plan.cluster & (plan.cluster - 1) == 0
    assert plan.cluster <= t
    assert plan.rows >= 1 and plan.rows & (plan.rows - 1) == 0
    assert plan.rows <= R.MAX_ROWS
    assert plan.row_blocks == -(-b // plan.rows) <= 65535
    assert 32 <= plan.threads <= R.THREADS and plan.threads % 32 == 0
    assert plan.trees >= 1
    lay = R.serve_smem_layout(plan.rows, plan.cluster, plan.trees, k, f,
                              ni_max, plan.stage, plan.rows_smem,
                              value_bytes)
    assert plan.smem == lay["total"] <= R.SMEM_MAX
    assert all(v % 16 == 0 for v in lay.values())
    # every (tree, row) pair once: the blocks' tree shares partition the
    # trees, the row blocks the rows, and a block walks the product of
    # its share and its rows (its pair loop covers trees * rows)
    chunk = plan.trees * plan.cluster
    seen = np.zeros(t, np.int64)
    for q in range(-(-t // chunk)):
        for rank in range(plan.cluster):
            tb = q * chunk + rank * plan.trees
            n = max(0, min(plan.trees, t - tb))
            seen[tb:tb + n] += 1
    assert np.all(seen == 1)
    rows = np.zeros(b, np.int64)
    summed = np.zeros(b, np.int64)
    rs = -(-plan.rows // plan.cluster)
    for y in range(plan.row_blocks):
        lo = y * plan.rows
        rows[lo:lo + plan.rows] += 1
        # each (row, class) is added by one thread of one block
        for rank in range(plan.cluster):
            r0 = rank * rs
            n = max(0, min(rs, plan.rows - r0))
            summed[lo + r0:lo + r0 + n] += 1
    assert np.all(rows == 1) and np.all(summed == 1)


@settings(max_examples=300, deadline=None)
@given(b=st.integers(1, 4096), f=st.integers(0, 4095),
       t=st.integers(1, 3000), ni_max=st.integers(1, 32767),
       mw=st.integers(0, 64), k=st.integers(1, 64),
       cluster=st.sampled_from([None, 1, 2, 4, 8]),
       rows=st.sampled_from([None, 1, 4, 32, 256]),
       ilp=st.sampled_from([None, 1, 2, 4]),
       threads=st.sampled_from([None, 32, 256, 512]),
       stage=st.sampled_from([None, False, True]),
       rows_smem=st.sampled_from([None, False, True]))
def test_forest_plan_fits_and_covers(b, f, t, ni_max, mw, k, cluster, rows,
                                     ilp, threads, stage, rows_smem):
    plan = R.forest_plan(b, f, t, ni_max, mw, k, cluster=cluster, rows=rows,
                         ilp=ilp, threads=threads, stage=stage,
                         rows_smem=rows_smem)
    _check_forest_plan(plan, b, f, t, ni_max, mw, k)
    assert plan.ilp in (1, 2, 4) and (ilp is None or plan.ilp == ilp)
    if ilp is None and plan.trees * plan.rows <= plan.threads:
        assert plan.ilp == 1
    if rows is not None:
        assert plan.rows <= rows
    if threads is not None:
        assert plan.threads <= threads
    if not stage:
        assert not plan.stage
    if rows_smem is False:
        assert not plan.rows_smem


def test_forest_plan_on_the_main_model():
    # 500 trees of 254 node slots at the main phase's request sizes:
    # single blocks, TARGET_BLOCKS blocks from 256 rows up, the rows in
    # shared memory, records through L1 unless staging is asked for
    big = R.forest_plan(4096, 28, 500, 254, 0, 1)
    assert (big.rows, big.cluster, big.blocks) == (16, 1, 256)
    assert big.rows_smem and not big.stage and big.ilp == R.ILP
    mid = R.forest_plan(256, 28, 500, 254, 0, 1)
    assert (mid.rows, mid.blocks, mid.trees, mid.ilp) == (1, 256, 500, 1)
    one = R.forest_plan(1, 28, 500, 254, 0, 1)
    assert (one.rows, one.row_blocks, one.trees, one.ilp) == (1, 1, 500, 1)
    assert R.forest_plan(4096, 28, 500, 254, 0, 1, cluster=8).rows == 128
    staged = R.forest_plan(4096, 28, 500, 254, 0, 1, rows=256, stage=True)
    assert staged.stage and staged.optin
    # every branch is reachable from the defaults or a request
    wide = R.forest_plan(4096, 4095, 500, 254, 0, 1)
    assert not wide.rows_smem
    assert R.forest_plan(4096, 28, 500, 254, 0, 1, cluster=1).cluster == 1
    assert R.forest_plan(64, 28, 3, 254, 0, 1, cluster=8).cluster == 2
    many = R.forest_plan(4096, 28, 500, 254, 0, 2000)         # classes
    assert many.smem <= R.SMEM_MAX and many.rows < 256
    for bad in ({"cluster": 3}, {"rows": 3}, {"rows": 512}, {"ilp": 3},
                {"threads": 48}, {"threads": 1024}):
        with pytest.raises(ValueError):
            R.forest_plan(8, 28, 500, 254, 0, 1, **bad)
    with pytest.raises(ValueError):
        R.forest_plan(0, 28, 500, 254, 0, 1)


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 4096), f=st.integers(0, 4095),
       tt=st.integers(1, 64), tiles=st.integers(1, 400),
       t=st.integers(0, 3000), k=st.integers(1, 64),
       rows_smem=st.sampled_from([None, False]))
def test_row_plans_fit_and_cover(b, f, tt, tiles, t, k, rows_smem):
    tp = R.traverse_plan(b, f, tt, tiles, rows_smem=rows_smem)
    assert 1 <= tp.rows <= R.TRAVERSE_ROWS and tp.rows & (tp.rows - 1) == 0
    assert tp.row_blocks == -(-b // tp.rows) <= 65535
    assert 32 <= tp.threads <= R.TRAVERSE_THREADS and tp.threads % 32 == 0
    assert tp.smem <= R.SMEM_MAX
    if tp.rows_smem:
        assert tp.smem == -(-tp.rows * (f | 1) * 4 // 16) * 16
    else:
        assert tp.smem == 0
        assert rows_smem is False or tp.rows * (f | 1) * 4 > R.SMEM_MAX
    ap = R.accumulate_plan(b, t, k)
    assert 1 <= ap.rows <= R.ACCUMULATE_ROWS
    assert ap.row_blocks == -(-b // ap.rows)
    assert 32 <= ap.threads <= R.ACCUMULATE_THREADS
    assert ap.threads % 32 == 0 and ap.trees >= 1
    assert ap.smem == R.serve_smem_layout(ap.rows, 1, ap.trees, k, 0, 1,
                                          False, False)["total"]
    assert ap.smem <= R.SMEM_MAX
