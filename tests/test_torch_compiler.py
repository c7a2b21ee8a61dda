"""The port's serving compiler against the JAX package's, on the CPU.

Plan and packed planes must be bitwise equal; the plain traverse must
route exactly as the Pallas kernel does in interpret mode, adversarial
and corrupted planes included; the plain f64 accumulation must equal the
JAX package's software binary64 adder bit for bit.  The CUDA kernels are
held to these plain versions on the card by chip_smoke.py.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import chip_smoke  # noqa: E402
import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu.compiler import build_plan as jax_build_plan  # noqa: E402
from lightgbm_tpu.compiler.kernel import _traverse_bucket  # noqa: E402
from lightgbm_tpu.ops.predict import \
    accumulate_slots_exact as jax_accumulate  # noqa: E402
from lightgbm_tpu_torch.compiler import build_plan  # noqa: E402
from lightgbm_tpu_torch.compiler.kernel import (  # noqa: E402
    traverse_bucket, traverse_bucket_plain)
from lightgbm_tpu_torch.ops.predict import (  # noqa: E402
    accumulate_slots_exact, accumulate_slots_exact_plain)
from lightgbm_tpu_torch.serving.runtime import ServingRuntime  # noqa: E402

GOLDEN = ("binary", "categorical", "goss_bagging", "multiclass",
          "regression_l2")
FAMILIES = GOLDEN + ("synthetic", "synthetic_wide")
#: small enough that every family plans into several tiles
TILE_KB = 1


def _model_text(name):
    if name == "synthetic":
        # chip_smoke.py's full-width forest, cut to 20 x 63 x 6: mixed
        # missing types and default directions, which the golden models
        # (missing type None throughout) never exercise
        return chip_smoke.synthetic_forest_text(0, num_trees=20,
                                                num_leaves=63,
                                                num_features=6)
    if name == "synthetic_wide":
        # 300 features: rows wider than the CUDA kernel keeps in shared
        # memory, so on the card it reads them from global memory
        return chip_smoke.synthetic_forest_text(1, num_trees=10,
                                                num_leaves=31,
                                                num_features=300)
    return (ROOT / "tests" / "data" / f"golden_{name}.model.txt").read_text()


def _pair(name):
    text = _model_text(name)
    return lgb.Booster(model_str=text), lt.Booster(model_str=text)


def _batch(bst_port):
    """The runtime's probe rows plus chip_smoke's adversarial rows, as
    the f32 rows the kernel sees (the runtime's staging cast)."""
    ex = bst_port.export_predict_arrays()
    rt = ServingRuntime(bst_port, device="cpu", tile_vmem_kb=TILE_KB)
    nf = max(bst_port.num_feature(), ex["stacked"]["min_features"])
    X = np.vstack([rt._probe_batch(ex, 256),
                   chip_smoke.adversarial_rows(ex["trees"], nf)])
    b = rt._chunk_rows(X.shape[0])
    return rt._stage32(X, b).numpy()


def _flush_subnormals(x):
    """f32 subnormals to signed zero: what XLA's CPU compares see."""
    x = x.copy()
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    x[sub] = np.copysign(0.0, x[sub])
    return x


def _assert_routes_like_pallas(x, planes):
    """The plain traverse against the Pallas kernel in interpret mode.
    XLA's CPU compares flush f32 subnormals to zero, while the port
    compares in IEEE f32 (as the CUDA kernel built without -ftz and the
    f64 host walk do).  So: the JAX side must route x as it routes x
    with its subnormals flushed, the port must route that flushed x
    bitwise as the JAX side routes x, and on every row without a
    subnormal the port must route x itself bitwise alike.  Returns the
    port's slots for x."""
    depth = planes["depth"]
    mw = planes["catw"].shape[-1] if "catw" in planes else 0
    flushed = _flush_subnormals(x)
    want = _jax_slots(x, planes, depth, mw)
    assert np.array_equal(want, _jax_slots(flushed, planes, depth, mw))
    got_flushed = _port_slots(flushed, planes, depth, mw)
    assert got_flushed.dtype == np.int32 and got_flushed.shape == want.shape
    assert np.array_equal(got_flushed, want)
    got = _port_slots(x, planes, depth, mw)
    normal = ~np.any(x != flushed, axis=1)
    assert normal.sum() > x.shape[0] // 2
    assert np.array_equal(got[:, normal], want[:, normal])
    return got


def _jax_slots(x, planes, depth, mw):
    catw = planes.get("catw")
    out = _traverse_bucket(
        jnp.asarray(x), jnp.asarray(planes["words"]),
        jnp.asarray(planes["kids"]), jnp.asarray(planes["pal"]),
        None if catw is None else jnp.asarray(catw), depth, mw,
        interpret=True)
    return np.asarray(out)


def _port_slots(x, planes, depth, mw):
    catw = planes.get("catw")
    return traverse_bucket(
        torch.from_numpy(x), torch.from_numpy(planes["words"]),
        torch.from_numpy(planes["kids"]), torch.from_numpy(planes["pal"]),
        None if catw is None else torch.from_numpy(catw), depth,
        mw).numpy()


@pytest.mark.parametrize("name", FAMILIES)
def test_plan_and_packed_planes_bitwise_equal(name):
    bj, bp = _pair(name)
    pj = jax_build_plan(bj.export_predict_arrays(), tile_vmem_kb=TILE_KB)
    pp = build_plan(bp.export_predict_arrays(), tile_vmem_kb=TILE_KB)
    assert pp.num_tiles() > 1
    assert np.array_equal(pp.perm, pj.perm)
    assert np.array_equal(pp.gather_idx, pj.gather_idx)
    assert [b.tiles for b in pp.buckets] == [b.tiles for b in pj.buckets]
    assert len(pp.planes) == len(pj.planes)
    for a, b in zip(pp.planes, pj.planes):
        assert a["depth"] == b["depth"]
        assert sorted(a) == sorted(b)
        for k in ("words", "kids", "pal", "catw"):
            if k in b:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k].view(np.uint32),
                                      b[k].view(np.uint32)), k
    assert pp.tile_stats == pj.tile_stats


@pytest.mark.parametrize("name", FAMILIES)
def test_plain_traverse_matches_pallas_interpret(name):
    _, bp = _pair(name)
    x = _batch(bp)
    plan = build_plan(bp.export_predict_arrays(), tile_vmem_kb=TILE_KB)
    for planes in plan.planes:
        if name == "synthetic_wide":
            # with 300 features nearly every adversarial row holds a
            # subnormal or a NaN somewhere; the other families cover the
            # subnormal rule, this one the wide feature gather, bitwise
            # on every row of the batch as XLA's CPU sees it
            xf = _flush_subnormals(x)
            mw = planes["catw"].shape[-1] if "catw" in planes else 0
            assert np.array_equal(
                _port_slots(xf, planes, planes["depth"], mw),
                _jax_slots(xf, planes, planes["depth"], mw))
        else:
            _assert_routes_like_pallas(x, planes)
    if name == "categorical":
        assert any("catw" in p for p in plan.planes)


def _corrupt(planes, kind):
    words = planes["words"]
    if kind == "child":            # the doctored root of
        planes["kids"][0, 0, 0] = (3 << 16) | 3   # test_serving_compiler
    elif kind == "cursor":         # both children past the node count
        ni = words.shape[2]
        planes["kids"][0, 0, 0] = (ni << 16) | (ni + 5)
    elif kind == "feature":        # feature id 4095 >= F, every node
        words[0, 0] |= 0xFFF << 16
    elif kind == "palette":        # code 65535 >= P, every node
        words[0, 0] |= 0xFFFF
    return planes


@pytest.mark.parametrize("kind", ["child", "cursor", "feature", "palette"])
@pytest.mark.parametrize("name", ["binary", "synthetic"])
def test_plain_traverse_matches_pallas_on_corrupted_planes(name, kind):
    # out-of-range reads give what the TPU kernel's one-hot gathers give
    # (0.0 feature, 0.0 threshold, root cursor, leaf 0)
    _, bp = _pair(name)
    x = _batch(bp)
    plan = build_plan(bp.export_predict_arrays(), tile_vmem_kb=TILE_KB)
    planes = _corrupt({k: v.copy() if isinstance(v, np.ndarray) else v
                       for k, v in plan.planes[0].items()}, kind)
    got = _assert_routes_like_pallas(x, planes)
    clean = _port_slots(x, plan.planes[0], plan.planes[0]["depth"], 0)
    assert not np.array_equal(got, clean), "corruption had no effect"


def test_subnormals_compare_in_ieee():
    # one numeric node at threshold 0.0: a positive f32 subnormal is
    # > 0 in IEEE f32, as in the f64 host walk, so it goes right; XLA's
    # CPU compare flushes it to zero and sends it left.  The port keeps
    # IEEE semantics (no flush), as the CUDA kernel does without -ftz
    text = (
        "tree\nversion=v4\nnum_class=1\nnum_tree_per_iteration=1\n"
        "label_index=0\nmax_feature_idx=0\nobjective=regression\n"
        "feature_names=Column_0\nfeature_infos=none\ntree_sizes=1\n\n"
        "Tree=0\nnum_leaves=2\nnum_cat=0\nsplit_feature=0\n"
        "split_gain=1\nthreshold=0\ndecision_type=0\nleft_child=-1\n"
        "right_child=-2\nleaf_value=1 2\nleaf_weight=1 1\nleaf_count=1 1\n"
        "internal_value=0\ninternal_weight=1\ninternal_count=2\n"
        "is_linear=0\nshrinkage=1\n\n\nend of trees\n")
    bp = lt.Booster(model_str=text)
    vals = np.array([1e-40, -1e-40, 1e-45, 0.0, -0.0], np.float32)
    X = vals.astype(np.float64).reshape(-1, 1)
    host = bp.predict(X, raw_score=True)
    assert list(host) == [2.0, 1.0, 2.0, 1.0, 1.0]
    rt = ServingRuntime(bp, device="cpu")
    assert np.array_equal(rt.predict(X, raw_score=True), host)
    plan = build_plan(bp.export_predict_arrays())
    p = plan.planes[0]
    x = np.zeros((8, 1), np.float32)
    x[:5, 0] = vals
    jax_left = _jax_slots(x, p, p["depth"], 0)[0, :5]
    assert list(jax_left) == [0, 0, 0, 0, 0]       # flushed: all left
    assert list(_port_slots(x, p, p["depth"], 0)[0, :5]) == [1, 0, 1, 0, 0]


@pytest.mark.parametrize("name", ["regression_l2", "multiclass"])
def test_plain_accumulation_matches_software_f64(name):
    # K = 1 and K = 3: routed slots of the batch, in boosting order
    bj, bp = _pair(name)
    x = _batch(bp)
    exj = bj.export_predict_arrays()
    exp_ = bp.export_predict_arrays()
    K = exp_["num_class"]
    from lightgbm_tpu_torch.ops.predict import predict_leaf_ensemble
    slots = predict_leaf_ensemble(exp_["stacked"], torch.from_numpy(x))
    cls = exp_["stacked"].get("cls")
    gidx = torch.arange(slots.shape[0], dtype=torch.int32)
    got = accumulate_slots_exact_plain(slots, gidx, exp_["value_f64"], K,
                                       cls).numpy()
    hi, lo = jax_accumulate(jnp.asarray(slots.numpy()), exj["value_hi"],
                            exj["value_lo"], n_class=K,
                            cls=exj["stacked"].get("cls"))
    want = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64))
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint64), want)
    # the wrapper on CPU tensors is the plain version; gather_idx picks
    # each tree's row in a permuted slot table
    perm = torch.randperm(slots.shape[0], generator=torch.Generator()
                          .manual_seed(0))
    shuffled = torch.empty_like(slots)
    shuffled[perm] = slots
    again = accumulate_slots_exact(shuffled, perm.to(torch.int32),
                                   exp_["value_f64"], K, cls).numpy()
    assert np.array_equal(again.view(np.uint64), want)
