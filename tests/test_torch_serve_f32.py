"""`device_predict`'s fused route on the CPU: the f32 instance of the fused
serving kernel (`compiler/kernel.py serve_forest_f32`, `csrc/serve.cu
lgbt_serve_f32`) through its plain version `serve_forest_f32_plain`.

Held bitwise:
  * the plain version over the plan's records against the JAX package's
    f32 scan (`lightgbm_tpu/ops/predict.py:188 predict_raw_ensemble`,
    `:212 predict_raw_ensemble_multi`) on the same stacked planes and
    f32 rows: binary, multiclass (K = 3), the categorical golden model
    (bitsets), a synthetic forest of mixed missing types and default
    directions on NaN, zero and out-of-range rows, a forest with
    single-leaf trees, and batches past ROW_BLOCK, padded;
  * the same against the unfused plain program (`traverse_bucket_plain`
    a bucket, then `accumulate_slots_f32_plain`), at any chunk of trees;
  * `Booster.predict(device_predict=True, device_type="cpu")` against
    the reference's `predict(device_predict=True)`, raw and converted,
    on the plan route (one fused call a chunk, no traverse, no
    standalone sum) and on the stacked route (unchanged);
  * the shared-memory layout's host mirror (`serve_smem_layout`) and
    `forest_plan`'s reckoning at 4 and 8 bytes a value, the f64 offsets
    as before.
The CUDA kernel is held to the plain version on the card by
chip_smoke.py's predict_api phase.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu.ops.predict import (  # noqa: E402
    predict_raw_ensemble, predict_raw_ensemble_multi)
from lightgbm_tpu_torch import booster as lt_booster  # noqa: E402
from lightgbm_tpu_torch.compiler import build_plan, kernel  # noqa: E402
from lightgbm_tpu_torch.compiler import records as R  # noqa: E402
from lightgbm_tpu_torch.ops import predict as lt_predict  # noqa: E402
from lightgbm_tpu_torch.serving.runtime import DEFAULT_TILE_KB  # noqa: E402
from test_torch_compiler import (_batch, _flush_subnormals,  # noqa: E402
                                 _model_text)
from test_torch_forest import _check_forest_plan  # noqa: E402

CPU = torch.device("cpu")
CASES = ("binary", "multiclass", "categorical", "synthetic", "single_leaf")
#: trees of the synthetic forest cut to a single leaf
SINGLE_LEAF = (0, 3, 4, 11, 19)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """ROADMAP Queue 3 (f): one intra-op thread for the links."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pair(name):
    """The reference's and the port's boosters of one model text; for
    "single_leaf" the synthetic forest with SINGLE_LEAF cut to their
    root's leaf in both."""
    text = _model_text("synthetic" if name == "single_leaf" else name)
    pair = lgb.Booster(model_str=text), lt.Booster(model_str=text)
    if name == "single_leaf":
        for bst in pair:
            for i in SINGLE_LEAF:
                bst.trees[i].num_leaves = 1
    return pair


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view({8: np.uint64, 4: np.uint32}[a.dtype.itemsize]),
        b.view({8: np.uint64, 4: np.uint32}[b.dtype.itemsize]))


_SCAN = jax.jit(predict_raw_ensemble)
_SCAN_MULTI = jax.jit(predict_raw_ensemble_multi, static_argnames="n_class")


def _jax_scan(bj, x, n_class):
    """The JAX package's f32 scan over the reference's stacked planes."""
    stacked = bj._stack_for_device(bj.trees)
    arrays = {k: jnp.asarray(v) for k, v in stacked.items()
              if k != "min_features"}
    out = (_SCAN_MULTI(arrays, jnp.asarray(x), n_class=n_class)
           if n_class > 1 else _SCAN(arrays, jnp.asarray(x)))
    return np.asarray(out)


def _unfused(bp, x):
    """The unfused plain program over the plan `device_predict` builds
    (averaging off): each bucket's plain traverse, then the f32 sum's
    plain version, tree t's slots at its plan row."""
    st_ = bp._device_predict_state(0, None, CPU)
    plan = build_plan(dict(bp.export_predict_arrays(device=CPU),
                           average_factor=1), tile_vmem_kb=DEFAULT_TILE_KB)
    planes, meta = kernel.device_planes(plan, CPU)
    slots = torch.cat([kernel.traverse_bucket_plain(x, *pl, depth, mw)
                       for pl, (depth, mw) in zip(planes, meta)])
    return lt_predict.accumulate_slots_f32_plain(
        slots, torch.from_numpy(plan.gather_idx), st_.values,
        st_.num_class, st_.cls)


@pytest.mark.parametrize("name", CASES)
def test_fused_f32_plain_matches_the_jax_scan(name):
    bj, bp = _pair(name)
    # XLA's CPU compares flush f32 subnormals (test_torch_compiler): both
    # sides see the flushed rows.  _batch pads past ROW_BLOCK rows.
    x = _flush_subnormals(_batch(bp))
    assert x.shape[0] > kernel.ROW_BLOCK
    st_ = bp._device_predict_state(0, None, CPU)
    assert st_.records is not None and st_.stacked is None
    # the same stacked planes on both sides
    mine = bp.export_predict_arrays(device=CPU)["stacked"]
    ref = bj._stack_for_device(bj.trees)
    for k in ("feat", "thr", "dtype", "left", "right", "value", "cls",
              "cat_nwords"):
        if k in ref:
            assert np.array_equal(mine[k].numpy(), np.asarray(ref[k])), k
    if name == "categorical":
        assert st_.records.mw > 0
        assert np.array_equal(mine["cat_words"].numpy().view(np.uint32),
                              ref["cat_words"])
    if name == "single_leaf":
        assert all(bp.trees[i].num_leaves == 1 for i in SINGLE_LEAF)
    K = st_.num_class
    got = kernel.serve_forest_f32_plain(torch.from_numpy(x), st_.records,
                                        st_.values, K)
    want = _jax_scan(bj, x, K)
    assert got.dtype == torch.float32 and _bits(got.numpy(), want)
    # the wrapper on a CPU tensor is the plain version
    assert _bits(kernel.serve_forest_f32(torch.from_numpy(x), st_.records,
                                         st_.values, K).numpy(), want)


@pytest.mark.parametrize("name", CASES)
def test_fused_f32_is_the_unfused_program(name):
    _, bp = _pair(name)
    x = torch.from_numpy(_batch(bp))        # subnormals kept: IEEE both
    st_ = bp._device_predict_state(0, None, CPU)
    K = st_.num_class
    want = _unfused(bp, x).numpy()
    T = st_.records.meta.shape[0]
    for chunk in (1, 7, T):
        got = kernel.serve_forest_f32_plain(x, st_.records, st_.values, K,
                                            chunk=chunk)
        assert _bits(got.numpy(), want)
    # the wrapper on a CPU tensor is the plain version
    assert _bits(kernel.serve_forest_f32(x, st_.records, st_.values,
                                         K).numpy(), want)


def _count_calls(monkeypatch):
    """Count the device program's calls: the fused f32 entry, the
    standalone traverse and the standalone f32 sum (`kernel`'s and
    `ops.predict`'s names)."""
    calls = {"serve_f32": 0, "traverse": 0, "accumulate_f32": 0}

    def counted(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(kernel, "serve_forest_f32",
                        counted("serve_f32", kernel.serve_forest_f32))
    monkeypatch.setattr(kernel, "traverse_bucket",
                        counted("traverse", kernel.traverse_bucket))
    monkeypatch.setattr(lt_predict, "accumulate_slots_f32", counted(
        "accumulate_f32", lt_predict.accumulate_slots_f32))
    return calls


@pytest.mark.parametrize("name", ["binary", "multiclass", "categorical"])
def test_device_predict_takes_the_fused_route(name, monkeypatch):
    bj, bp = _pair(name)
    nf = bp.num_feature()
    rng = np.random.RandomState(5)
    X = rng.randn(600, nf)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    X[rng.rand(*X.shape) < 0.03] = 0.0
    X[:4, 0] = [1e300, -1e300, np.inf, -np.inf]
    calls = _count_calls(monkeypatch)
    monkeypatch.setattr(lt_booster, "DEVICE_PREDICT_CHUNK", 256)
    for raw in (True, False):
        got = bp.predict(X, raw_score=raw, device_predict=True,
                         device_type="cpu")
        assert _bits(got, bj.predict(X, raw_score=raw, device_predict=True))
    # three chunks a call, one fused call each, nothing else
    assert calls == {"serve_f32": 6, "traverse": 0, "accumulate_f32": 0}


def test_stacked_route_is_unchanged(monkeypatch):
    """A split on feature 4096 leaves the plan's 12-bit field: no
    records, the stacked traversal and the standalone f32 sum a chunk,
    bitwise the reference (ROADMAP Queue 3 (q))."""
    bj, bp = _pair("regression_l2")
    for bst in (bj, bp):
        bst.trees[0].split_feature[0] = 4096
    rng = np.random.RandomState(3)
    X = np.zeros((300, 4097))
    X[:, :bp.num_feature()] = rng.randn(300, bp.num_feature())
    X[:, 4096] = rng.randn(300)
    X[::9, 4096] = np.nan
    assert bp._device_predict_state(0, None, CPU).records is None
    calls = _count_calls(monkeypatch)
    for raw in (True, False):
        got = bp.predict(X, raw_score=raw, device_predict=True,
                         device_type="cpu")
        assert _bits(got, bj.predict(X, raw_score=raw, device_predict=True))
    assert calls == {"serve_f32": 0, "traverse": 0, "accumulate_f32": 2}


def test_plan_route_stages_rows_unpadded(monkeypatch):
    """The fused route takes chunks of any length: a chunk past ROW_BLOCK
    rows reaches `serve_forest_f32` unpadded (the stacked route and the
    standalone traverse keep their padding), with the reference's bits."""
    bj, bp = _pair("binary")
    chunk = kernel.ROW_BLOCK + 30
    X = np.random.RandomState(9).randn(2 * chunk + 44, bp.num_feature())
    seen = []
    fused = kernel.serve_forest_f32

    def spy(Xd, *a, **kw):
        seen.append(Xd.shape[0])
        return fused(Xd, *a, **kw)

    monkeypatch.setattr(kernel, "serve_forest_f32", spy)
    monkeypatch.setattr(lt_booster, "DEVICE_PREDICT_CHUNK", chunk)
    got = bp.predict(X, raw_score=True, device_predict=True,
                     device_type="cpu")
    assert _bits(got, bj.predict(X, raw_score=True, device_predict=True))
    assert seen == [chunk, chunk, 44]
    assert lt_booster.stage_rows(X, CPU).shape[0] == 3 * kernel.ROW_BLOCK
    assert lt_booster.stage_rows(X, CPU, pad=False).shape[0] == X.shape[0]


@pytest.mark.parametrize("name", ["binary", "multiclass", "categorical",
                                  "single_leaf"])
def test_serve_bytes_counts_the_walks(name):
    """chip_smoke.py's bound of the fused launch (`_serve_bytes`): its
    record visits are the host walk's leaf depths summed (a single-leaf
    tree's root counted), and the sectors it counts grow with the rows
    up to at most the whole tables."""
    from chip_smoke import _leaf_depths, _serve_bytes
    _, bp = _pair(name)
    st_ = bp._device_predict_state(0, None, CPU)
    ex = bp.export_predict_arrays(device=CPU)
    nl = ex["leaf_values"].shape[1]
    depth = np.maximum(_leaf_depths(ex["trees"], nl), 1)
    x = _batch(bp)
    K = st_.num_class
    plan = build_plan(dict(ex, average_factor=1),
                      tile_vmem_kb=DEFAULT_TILE_KB)
    planes, meta = kernel.device_planes(plan, CPU)
    slots = torch.cat([kernel.traverse_bucket_plain(
        torch.from_numpy(x), *pl, d, mw) for pl, (d, mw) in zip(planes, meta)])
    leaves = slots[torch.from_numpy(plan.gather_idx).long()].numpy()
    nbytes, visits = _serve_bytes(torch.from_numpy(x), st_.records,
                                  st_.values, K)
    assert visits == int(np.take_along_axis(depth, leaves, 1).sum())
    b, f = x.shape
    t_trees = st_.values.shape[0]
    rec = st_.records

    def sectors(t):         # a whole table, in 32-byte sectors
        return -(-t.numel() * t.element_size() // 32) * 32

    whole = (b * f * 4 + t_trees * 16 + sectors(rec.nodes)
             + (sectors(rec.catw) if rec.mw else 0) + sectors(st_.values)
             + b * K * 4)
    one, _ = _serve_bytes(torch.from_numpy(x[:1]), st_.records, st_.values,
                          K)
    assert one <= nbytes <= whole
    assert one < whole - b * f * 4


def test_serve_f32_wrapper_checks_and_never_falls_back():
    _, bp = _pair("binary")
    st_ = bp._device_predict_state(0, None, CPU)
    x = torch.zeros((3, bp.num_feature()), dtype=torch.float32)
    with pytest.raises(lt.LightGBMError, match="float32"):
        kernel.serve_forest_f32(x, st_.records, st_.values.double())
    with pytest.raises(lt.LightGBMError, match="float64"):
        kernel.serve_forest(x, st_.records, st_.values)
    # a tensor on neither the CPU nor a CUDA device: no kernel, no plain
    # version in its place
    with pytest.raises(lt.LightGBMError, match="no serve kernel"):
        kernel.serve_forest_f32(x.to("meta"), st_.records, st_.values)


def _layout(rows, cluster, trees, k, f, ni_max, stage, rows_smem, vb):
    """`csrc/forest_common.cuh layout`, written out."""
    def a16(n):
        return -(-n // 16) * 16
    rs = -(-rows // cluster)
    acc = a16(2 * trees * rows * vb)
    recs = acc + a16(rs * k * vb)
    xs = recs + (2 * trees * ni_max * 16 if stage else 0)
    return {"vals": 0, "acc": acc, "recs": recs, "xs": xs,
            "total": xs + (a16(rows * (f | 1) * 4) if rows_smem else 0)}


@settings(max_examples=200, deadline=None)
@given(rows=st.sampled_from([1, 2, 4, 16, 64, 256]),
       cluster=st.sampled_from([1, 2, 4, 8]), trees=st.integers(1, 512),
       k=st.integers(1, 64), f=st.integers(0, 4095),
       ni_max=st.integers(1, 512), stage=st.booleans(),
       rows_smem=st.booleans())
def test_smem_layout_at_4_and_8_bytes(rows, cluster, trees, k, f, ni_max,
                                      stage, rows_smem):
    args = (rows, cluster, trees, k, f, ni_max, stage, rows_smem)
    f64 = R.serve_smem_layout(*args)
    assert f64 == R.serve_smem_layout(*args, 8) == _layout(*args, 8)
    f32 = R.serve_smem_layout(*args, 4)
    assert f32 == _layout(*args, 4)
    assert f32["acc"] <= f64["acc"] and f32["total"] <= f64["total"]
    assert all(v % 16 == 0 for v in f32.values() if v)


def test_smem_layout_f64_offsets_unchanged():
    # the main model's default 4096-row plan and a staged cluster plan,
    # byte for byte as the f64 kernel lays them out; then the default
    # plan's layout at 4 bytes a value
    assert R.serve_smem_layout(16, 1, 128, 1, 28, 254, False, True) == {
        "vals": 0, "acc": 32768, "recs": 32896, "xs": 32896,
        "total": 34752}
    assert R.serve_smem_layout(128, 8, 16, 3, 28, 254, True, True) == {
        "vals": 0, "acc": 32768, "recs": 33152, "xs": 163200,
        "total": 178048}
    assert R.serve_smem_layout(16, 1, 128, 1, 28, 254, False, True, 4) == {
        "vals": 0, "acc": 16384, "recs": 16448, "xs": 16448,
        "total": 18304}
    with pytest.raises(ValueError):
        R.serve_smem_layout(16, 1, 128, 1, 28, 254, False, True, 2)


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 4096), f=st.integers(0, 4095),
       t=st.integers(1, 3000), ni_max=st.integers(1, 32767),
       mw=st.integers(0, 64), k=st.integers(1, 2000),
       cluster=st.sampled_from([None, 1, 8]),
       rows=st.sampled_from([None, 1, 32, 256]),
       stage=st.sampled_from([None, True]))
def test_forest_plan_at_4_bytes_fits_and_covers(b, f, t, ni_max, mw, k,
                                                cluster, rows, stage):
    kw = dict(cluster=cluster, rows=rows, stage=stage)
    try:
        f64 = R.forest_plan(b, f, t, ni_max, mw, k, **kw)
    except ValueError:
        f64 = None
    p32 = R.forest_plan(b, f, t, ni_max, mw, k, value_bytes=4, **kw)
    _check_forest_plan(p32, b, f, t, ni_max, mw, k, value_bytes=4)
    if f64 is not None:
        _check_forest_plan(f64, b, f, t, ni_max, mw, k)
        assert f64 == R.forest_plan(b, f, t, ni_max, mw, k, value_bytes=8,
                                    **kw)
        # half the bytes a value never gives a smaller chunk or row block
        assert p32.rows >= f64.rows and p32.trees >= f64.trees


def test_forest_plan_f32_on_the_main_model():
    # while the grid has at most TARGET_BLOCKS blocks the main model's
    # f32 plans are the f64 ones with half the value bytes; past it the
    # f32 instance walks one cursor a thread, the f64 one still two
    for b in (1, 256, 1024, 4096, 16384, 65536):
        f64 = R.forest_plan(b, 28, 500, 254, 0, 1)
        p32 = R.forest_plan(b, 28, 500, 254, 0, 1, value_bytes=4)
        assert p32.smem < f64.smem
        if f64.blocks <= R.TARGET_BLOCKS:
            assert p32._replace(smem=f64.smem) == f64
        else:
            assert p32._replace(smem=f64.smem, ilp=f64.ilp) == f64
            assert (p32.ilp, f64.ilp) == (1, R.ILP)
    assert R.forest_plan(65536, 28, 500, 254, 0, 1,
                         value_bytes=4).row_blocks == 4096
    # a full chunk in blocks of one row would pass the grid's 65,535
    # row blocks: refused, not launched
    with pytest.raises(ValueError, match="row blocks"):
        R.forest_plan(65536, 28, 500, 254, 0, 1, rows=1, value_bytes=4)
    assert R.forest_plan(65535, 28, 500, 254, 0, 1, rows=1).row_blocks \
        == R.MAX_ROW_BLOCKS
    # many classes: the f32 accumulators fit more rows a block
    many = R.forest_plan(4096, 28, 500, 254, 0, 3000)
    many32 = R.forest_plan(4096, 28, 500, 254, 0, 3000, value_bytes=4)
    assert many32.rows > many.rows and many32.smem <= R.SMEM_MAX
