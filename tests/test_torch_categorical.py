"""Categorical splits in the port against the JAX package, on the CPU.

* `find_best_split` with `has_cat=True` against the reference's on
  random histograms, every field of the result bitwise, `cat_mask`
  included: one-vs-rest (case 2), the sorted prefixes ascending and
  descending (cases 3 and 4), more used bins than `max_cat_threshold`,
  ratio ties, empty bins, NaN-missing numerical features beside the
  categorical ones, an extra_trees candidate grid, path smoothing, and
  a batch of leaves searched at once;
* the fused wave's search (numerical candidates decided over the
  numerical features, the categorical search alone, then
  `merge_split_results`) equal to the full search, and the merge's tie
  rule against the reference's;
* `Tree.from_device` on categorical splits (bitsets of up to 313
  words) against the reference's;
* `lt.train` against the live `lgb.train`, model text byte for byte,
  under both growers, f32 and quantized, the wave fused and unfused:
  the `categorical` golden family, `max_cat_to_onehot=16` (case 2
  wins), a 60-level column with `max_cat_threshold=8`, extra_trees and
  a validation set; NaN and unseen categories at predict, host and
  served, against the reference's predictions.
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

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu.ops import split as jsplit  # noqa: E402
from lightgbm_tpu.ops.grow import DeviceTree as JDeviceTree  # noqa: E402
from lightgbm_tpu.tree import Tree as JTree  # noqa: E402
from lightgbm_tpu_torch.ops import split as tsplit  # noqa: E402
from lightgbm_tpu_torch.ops.grow import DeviceTree  # noqa: E402
from lightgbm_tpu_torch.tree import Tree  # noqa: E402

FIELDS = ("gain", "feature", "threshold_bin", "default_left", "is_cat",
          "cat_mask", "left_sum_g", "left_sum_h", "left_cnt", "right_sum_g",
          "right_sum_h", "right_cnt")
BASE = dict(l1=0.1, l2=1.0, min_data_in_leaf=3.0, min_sum_hessian=1e-3,
            min_gain_to_split=0.0, cat_smooth=10.0, cat_l2=10.0,
            max_cat_threshold=32, max_cat_to_onehot=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in test_torch_train.py (ROADMAP Queue 3
    (f)): the trainings go through sigmoid."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _leaf(seed, kind, f=6, mb=64):
    """One leaf's histogram: features 0-1 numerical (missing none and
    NaN), the rest categorical with `kind`'s used-bin layout; the parent
    is feature 0's column sum."""
    nb = np.full(f, mb, np.int32)       # one layout for every leaf
    nb[2:] = np.random.RandomState(0).randint(6, mb + 1, f - 2)
    rng = np.random.RandomState(seed)
    missing = np.array([0, 2] + [0] * (f - 2), np.int32)
    default = np.zeros(f, np.int32)
    is_cat = np.arange(f) >= 2
    cnt = rng.poisson(12, (f, mb)).astype(np.float32)
    if kind == "onehot":
        # at most max_cat_to_onehot = 4 used bins per categorical feature
        for j in range(2, f):
            keep = rng.choice(np.arange(1, nb[j]), rng.randint(1, 5), False)
            row = np.zeros(mb, np.float32)
            row[keep] = cnt[j, keep] + 5
            row[0] = cnt[j, 0]
            cnt[j] = row
    elif kind == "empty":
        cnt[2:] *= rng.rand(f - 2, mb) < 0.3
    g = (rng.randn(f, mb) * np.sqrt(cnt + 1)).astype(np.float32)
    # the categories carry a signal, so that their cases win
    g[2:] += (cnt[2:] * rng.randn(f - 2, mb) * 0.6).astype(np.float32)
    h = (cnt * rng.uniform(0.05, 0.25, (f, mb))).astype(np.float32)
    if kind == "ties":
        # many bins with one (g, h): their ratios tie exactly
        for j in range(2, f):
            same = rng.rand(mb) < 0.5
            g[j, same], h[j, same], cnt[j, same] = -3.0, 1.5, 7.0
    g[cnt == 0] = 0.0
    h[cnt == 0] = 0.0
    hist = np.stack([g, h, cnt], axis=-1)
    hist[np.arange(mb)[None, :] >= nb[:, None]] = 0.0
    parent = hist[0].sum(axis=0)
    allowed = np.ones(f, bool)
    if kind == "gated":
        allowed[rng.rand(f) < 0.4] = False
    return hist, parent, nb, missing, default, is_cat, allowed


def _jax(leaf, p, p_out=0.0, cand=None, path_smooth=0.0):
    hist, parent, nb, missing, default, is_cat, allowed = leaf
    return jsplit.find_best_split(
        jnp.asarray(hist), jnp.float32(parent[0]), jnp.float32(parent[1]),
        jnp.float32(parent[2]), jnp.asarray(nb), jnp.asarray(missing),
        jnp.asarray(default), jnp.asarray(allowed), jnp.asarray(is_cat),
        p["l1"], p["l2"], p["min_data_in_leaf"], p["min_sum_hessian"],
        p["min_gain_to_split"], p["cat_smooth"], p["cat_l2"],
        p["max_cat_threshold"], p["max_cat_to_onehot"],
        path_smooth=path_smooth, parent_output=jnp.float32(p_out),
        cand_mask=None if cand is None else jnp.asarray(cand),
        has_cat=True)


def _port(leaves, p, p_out=0.0, cand=None, path_smooth=0.0,
          numerical=True):
    """The port's search over a batch of leaves."""
    hist = torch.from_numpy(np.stack([lf[0] for lf in leaves]))
    parent = torch.from_numpy(np.stack([lf[1] for lf in leaves]))
    _, _, nb, missing, default, is_cat, _ = leaves[0]
    allowed = torch.from_numpy(np.stack([lf[6] for lf in leaves]))
    return tsplit.find_best_split(
        hist, parent[:, 0], parent[:, 1], parent[:, 2],
        torch.from_numpy(nb), torch.from_numpy(missing),
        torch.from_numpy(default), allowed, p["l1"], p["l2"],
        p["min_data_in_leaf"], p["min_sum_hessian"], p["min_gain_to_split"],
        path_smooth=path_smooth,
        parent_output=torch.full((len(leaves),), np.float32(p_out)),
        cand_mask=None if cand is None else torch.from_numpy(cand),
        is_cat=torch.from_numpy(is_cat), cat_smooth=p["cat_smooth"],
        cat_l2=p["cat_l2"], max_cat_threshold=p["max_cat_threshold"],
        max_cat_to_onehot=p["max_cat_to_onehot"], has_cat=True,
        numerical=numerical)


def _assert_same(t, i, j, ctx):
    for name in FIELDS:
        a = np.asarray(getattr(t, name)[i])
        b = np.asarray(getattr(j, name))
        if a.dtype == np.float32:
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), \
                (ctx, name, a, b)
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), \
                (ctx, name, a, b)


SEARCH_CASES = {
    "onehot": ("onehot", {}),
    "sorted": ("sorted", {}),
    "over_threshold": ("sorted", {"max_cat_threshold": 3}),
    "ties": ("ties", {}),
    "empty": ("empty", {}),
    "gated": ("gated", {"min_data_in_leaf": 20.0}),
    "sized": ("sorted", {"min_data_in_leaf": 200.0, "min_sum_hessian": 30.0,
                         "min_gain_to_split": 0.5, "l1": 0.0, "l2": 0.0}),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_matches_the_reference_field_for_field(case):
    """Eight leaves searched in one batched call; each field of each row
    is the reference's single-leaf result, bitwise."""
    kind, over = SEARCH_CASES[case]
    p = dict(BASE, **over)
    leaves = [_leaf(1000 * len(case) + s, kind) for s in range(8)]
    res = _port(leaves, p)
    won = set()
    for i, leaf in enumerate(leaves):
        j = _jax(leaf, p)
        _assert_same(res, i, j, (case, i))
        if bool(j.is_cat):
            won.add("onehot" if int(np.asarray(j.cat_mask).sum()) == 1
                    and case == "onehot" else "cat")
    # the categorical cases really win somewhere
    assert won, case
    if case == "onehot":
        assert "onehot" in won


def test_descending_prefix_and_path_smoothing_match():
    """Path smoothing switches the categorical gains to the given-output
    form (cat_l2 inside); leaves whose best split is a descending
    prefix (a mask whose bins have the largest ratios) are among the
    cases."""
    p = dict(BASE)
    cases = 0
    for smooth in (0.0, 3.0):
        leaves = [_leaf(77 + s, "sorted") for s in range(10)]
        res = _port(leaves, p, p_out=0.2, path_smooth=smooth)
        for i, leaf in enumerate(leaves):
            j = _jax(leaf, p, p_out=0.2, path_smooth=smooth)
            _assert_same(res, i, j, (smooth, i))
            if bool(j.is_cat):
                hist = leaf[0][int(j.feature)]
                mask = np.asarray(j.cat_mask)
                ratio = hist[:, 0] / (hist[:, 1] + np.float32(10.0))
                used = (np.arange(len(mask)) >= 1) & (hist[:, 2] > 0)
                cases += ratio[mask].min() >= ratio[used & ~mask].max()
    assert cases > 0


def test_extra_trees_grid_keeps_every_categorical_candidate():
    p = dict(BASE)
    rng = np.random.RandomState(5)
    leaves = [_leaf(300 + s, "sorted") for s in range(6)]
    f, mb = leaves[0][0].shape[:2]
    pick = rng.randint(0, mb, f)
    cand = (np.arange(mb)[None, :] == pick[:, None]) | leaves[0][5][:, None]
    res = _port(leaves, p, cand=cand)
    for i, leaf in enumerate(leaves):
        _assert_same(res, i, _jax(leaf, p, cand=cand), i)


@pytest.mark.parametrize("kind", ["sorted", "onehot", "gated"])
def test_fused_split_of_equals_the_full_search(kind):
    """The fused wave's decision (the numerical candidates over the
    numerical features, the categorical search alone, merged) is the
    full search's, field for field, and the reference's."""
    p = dict(BASE)
    leaves = [_leaf(900 + s, kind) for s in range(8)]
    full = _port(leaves, p)
    hist = torch.from_numpy(np.stack([lf[0] for lf in leaves]))
    parent = torch.from_numpy(np.stack([lf[1] for lf in leaves]))
    _, _, nb, missing, default, is_cat, _ = leaves[0]
    allowed = torch.from_numpy(np.stack([lf[6] for lf in leaves]))
    scan = dict(l1=p["l1"], l2=p["l2"],
                min_data_in_leaf=p["min_data_in_leaf"],
                min_sum_hessian=p["min_sum_hessian"],
                min_gain_to_split=p["min_gain_to_split"])
    cand = tsplit.fused_numerical_candidates(
        hist.transpose(0, 1), torch.from_numpy(nb),
        torch.from_numpy(missing), parent, **scan).permute(1, 2, 0, 3)
    num = tsplit.decide_from_candidates(
        cand, parent[:, 0], parent[:, 1], parent[:, 2],
        torch.from_numpy(missing), torch.from_numpy(default),
        allowed & ~torch.from_numpy(is_cat)[None])
    cat = _port(leaves, p, numerical=False)
    merged = tsplit.merge_split_results(num, cat)
    for i, leaf in enumerate(leaves):
        j = _jax(leaf, p)
        _assert_same(merged, i, j, (kind, i))
        for name in FIELDS:
            assert torch.equal(getattr(merged, name)[i],
                               getattr(full, name)[i]), (kind, i, name)


def test_merge_ties_go_to_the_numerical_result():
    """Equal gains keep the numerical result, as the reference's merge
    does; a larger categorical gain takes every field, mask included."""
    mb = 8

    def result(lib, gain, feat, cat):
        arr = jnp.asarray if lib is jsplit else torch.tensor
        mask = np.zeros(mb, bool)
        mask[[2, 5]] = cat
        vals = dict(gain=np.float32(gain), feature=np.int32(feat),
                    threshold_bin=np.int32(3), default_left=np.bool_(not cat),
                    is_cat=np.bool_(cat), cat_mask=mask,
                    left_sum_g=np.float32(feat), left_sum_h=np.float32(2.0),
                    left_cnt=np.float32(9.0), right_sum_g=np.float32(-1.0),
                    right_sum_h=np.float32(3.0), right_cnt=np.float32(4.0))
        return lib.SplitResult(**{k: arr(v) for k, v in vals.items()})

    for cat_gain in (1.5, 2.5, float("-inf")):
        args = (1.5, 1, False), (cat_gain, 4, True)
        j = jsplit.merge_split_results(*(result(jsplit, *a) for a in args))
        t = tsplit.merge_split_results(*(result(tsplit, *a) for a in args))
        for name in FIELDS:
            a, b = np.asarray(getattr(t, name)), np.asarray(getattr(j, name))
            assert np.array_equal(a, b), (cat_gain, name)
        assert bool(t.is_cat) == (cat_gain > 1.5)


def test_from_device_builds_the_reference_bitsets():
    """Categorical splits on a feature with categories up to 9999 (313
    bitset words), the left subsets from several bins: `to_string` and
    every array equal the reference's."""
    rng = np.random.RandomState(3)
    cats = np.sort(rng.choice(10000, 59, replace=False))
    cats[-1] = 9999
    col = cats[rng.randint(0, 59, 3000)].astype(np.float64)
    X = np.stack([rng.randn(3000), col], axis=1)
    y = rng.randn(3000)
    mappers = []
    for pkg in (lgb, lt):
        ds = pkg.Dataset(X, label=y, categorical_feature=[1]).construct()
        mappers.append(ds.bin_mappers)
    mb = max(m.num_bin for m in mappers[1])
    L = 5
    masks = np.zeros((L - 1, mb), bool)
    masks[0, [1, 7, 59]] = True
    masks[2, 3] = True
    ncat = mappers[1][1].num_bin
    masks[3, 1:ncat] = rng.rand(ncat - 1) < 0.5
    fields = dict(
        n_splits=np.int32(4), split_leaf=np.array([0, 0, 1, 2], np.int32),
        split_feature=np.array([1, 0, 1, 1], np.int32),
        threshold_bin=np.array([0, 11, 0, 0], np.int32),
        default_left=np.array([False, True, False, False]),
        split_is_cat=np.array([True, False, True, True]),
        split_cat_mask=masks,
        split_gain=np.array([3.0, 2.0, 1.0, 0.5], np.float32),
        internal_g=np.array([1.0, -2.0, 0.5, 0.25], np.float32),
        internal_h=np.array([30.0, 20.0, 10.0, 5.0], np.float32),
        internal_cnt=np.array([300, 200, 100, 50], np.float32),
        leaf_value=np.array([0.1, -0.2, 0.3, -0.4, 0.5], np.float32),
        leaf_g=np.zeros(L, np.float32),
        leaf_h=np.array([1, 2, 3, 4, 5], np.float32),
        leaf_cnt=np.array([10, 20, 30, 40, 50], np.float32))
    jt = JTree.from_device(JDeviceTree(leaf_id=np.zeros(3, np.int32),
                                       **fields), mappers[0], 0.1)
    tt = Tree.from_device(DeviceTree(leaf_id=None, values=None, **fields),
                          mappers[1], 0.1)
    assert tt.to_string(0) == jt.to_string(0)
    assert tt.num_cat == jt.num_cat == 3
    for name in ("cat_boundaries", "cat_threshold", "cat_bin_masks",
                 "decision_type", "threshold", "threshold_bin"):
        assert np.array_equal(getattr(tt, name), getattr(jt, name)), name
    assert int(np.diff(tt.cat_boundaries).max()) == 313
    np.testing.assert_array_equal(tt.predict(X), jt.predict(X))


# --------------------------------------------------------------- training
def _train_pair(params, X, y, rounds, cat_idx, port_extra=(), **fit):
    """The reference's model and the port's, one for each of
    `port_extra`'s parameter sets (the wave fused and unfused)."""
    bj = lgb.train(dict(params), lgb.Dataset(X, label=y,
                                             categorical_feature=cat_idx),
                   num_boost_round=rounds, **fit)
    ports = []
    for extra in port_extra or ({},):
        ports.append(lt.train(dict(params, **extra), lt.Dataset(
            X, label=y, categorical_feature=cat_idx), num_boost_round=rounds,
            **fit))
    return bj, ports


def _assert_text_equal(bj, ports, ignore=("tpu_fused_split",)):
    ref = bj.model_to_string()
    for bp in ports:
        got = bp.model_to_string()
        if bp.params.get("tpu_fused_split") is False:
            got = "\n".join(ln for ln in got.split("\n")
                            if not any(k in ln for k in ignore))
            want = "\n".join(ln for ln in ref.split("\n")
                             if not any(k in ln for k in ignore))
            assert got == want
        else:
            assert got == ref


def _wide_cat(seed, n=2500):
    """Two numerical columns and a 60-level categorical one."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3)
    X[:, 2] = rng.randint(0, 60, n)
    eff = rng.randn(60)
    y = (X[:, 0] + eff[X[:, 2].astype(int)] + 0.4 * rng.randn(n) > 0)
    return X, y.astype(np.float64)


POLICIES = [("leafwise", {}), ("wave", {}), ("leafwise", {"q": 1}),
            ("wave", {"q": 1})]
POLICY_IDS = ["strict", "wave", "strict_quant", "wave_quant"]


def _params(base, policy, q):
    p = dict(base, device_type="cpu", tree_grow_policy=policy)
    if q:
        p["use_quantized_grad"] = True
    return p


def _port_variants(policy):
    return ({}, {"tpu_fused_split": False}) if policy == "wave" else ({},)


@pytest.mark.parametrize("policy,opt", POLICIES, ids=POLICY_IDS)
def test_golden_categorical_family_byte_identical(policy, opt):
    case = GOLDEN_CASES["categorical"]
    X, y = make_case_data(case)
    bj, ports = _train_pair(_params(case["params"], policy, opt.get("q")),
                            X, y, case["rounds"], case["categorical"],
                            _port_variants(policy))
    _assert_text_equal(bj, ports)
    assert sum(t.num_cat for t in ports[0].trees) > 0
    if policy == "wave" and not opt:
        assert ports[0]._grower_spec.fused
        assert not ports[1]._grower_spec.fused


@pytest.mark.parametrize("policy,opt", POLICIES, ids=POLICY_IDS)
def test_one_vs_rest_wins_with_max_cat_to_onehot_16(policy, opt):
    case = GOLDEN_CASES["categorical"]
    X, y = make_case_data(case)
    params = dict(case["params"], max_cat_to_onehot=16)
    bj, ports = _train_pair(_params(params, policy, opt.get("q")), X, y, 4,
                            case["categorical"], _port_variants(policy))
    _assert_text_equal(bj, ports)
    # a one-vs-rest bitset holds one category
    sizes = [bin(int(w)).count("1") for t in ports[0].trees
             for w in t.cat_threshold]
    assert sizes and 1 in sizes


@pytest.mark.parametrize("policy,opt", POLICIES, ids=POLICY_IDS)
def test_sixty_levels_past_max_cat_threshold(policy, opt):
    """Sorted prefixes capped at 8 bins of a 60-level column."""
    X, y = _wide_cat(8)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "max_cat_threshold": 8}
    bj, ports = _train_pair(_params(params, policy, opt.get("q")), X, y, 4,
                            [2], _port_variants(policy))
    _assert_text_equal(bj, ports)
    assert sum(t.num_cat for t in ports[0].trees) > 0


def test_extra_trees_with_categoricals_byte_identical():
    """extra_trees keeps every candidate of a categorical feature (the
    wave runs unfused, on the strict grower's search)."""
    X, y = _wide_cat(9)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "extra_trees": True}
    bj, ports = _train_pair(_params(params, "wave", 0), X, y, 4, [2])
    _assert_text_equal(bj, ports)
    assert sum(t.num_cat for t in ports[0].trees) > 0


def test_valid_set_and_unseen_categories_match():
    """A validation set's eval log (its rows replayed on their bins,
    categorical masks included), then NaN, negative and unseen
    categories at predict: host and served scores equal the
    reference's."""
    X, y = _wide_cat(10)
    Xv, yv = _wide_cat(11, n=700)
    Xv[:40, 2] = np.nan
    Xv[40:80, 2] = 75.0             # never seen in training
    Xv[80:100, 2] = -3.0
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "metric": ["binary_logloss", "auc"],
              "tree_grow_policy": "wave", "device_type": "cpu"}
    logs, boosters = [], []
    for pkg in (lgb, lt):
        ds = pkg.Dataset(X, label=y, categorical_feature=[2])
        rec = {}
        boosters.append(pkg.train(
            dict(params), ds, num_boost_round=5,
            valid_sets=[ds.create_valid(Xv, label=yv)],
            valid_names=["valid"], callbacks=[pkg.record_evaluation(rec)]))
        logs.append(rec)
    for metric in ("binary_logloss", "auc"):
        np.testing.assert_allclose(logs[1]["valid"][metric],
                                   logs[0]["valid"][metric], rtol=1e-6,
                                   err_msg=metric)
    bj, bp = boosters
    assert bp.model_to_string() == bj.model_to_string()
    raw_j = bj.predict(Xv, raw_score=True)
    np.testing.assert_array_equal(bp.predict(Xv, raw_score=True), raw_j)
    rt = lt.ServingRuntime(lt.Booster(model_str=bp.model_to_string()),
                           device="cpu")
    np.testing.assert_array_equal(rt.predict(Xv, raw_score=True), raw_j)


def test_313_word_bitsets_train_and_serve_as_the_reference():
    """A column whose levels are 9984 .. 9999 (bitset word 312): every
    categorical split stores 313 words; the model text equals the
    reference's, and the served scores (records padded to 313 words)
    equal its predictions on NaN, negative, unseen and out-of-range
    categories."""
    rng = np.random.RandomState(12)
    n = 3000
    level = rng.randint(0, 16, n)
    X = np.stack([rng.randn(n), 9984.0 + level], axis=1)
    y = (rng.randn(16)[level] + 0.5 * X[:, 0] + rng.randn(n) > 0)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "tree_grow_policy": "wave"}
    bj, (bp,) = _train_pair(_params(params, "wave", 0), X,
                            y.astype(np.float64), 3, [1])
    _assert_text_equal(bj, [bp])
    assert sum(t.num_cat for t in bp.trees) > 0
    assert {int(w) for t in bp.trees
            for w in np.diff(t.cat_boundaries)} == {313}
    Xv = X[:700].copy()
    for k, v in enumerate((np.nan, -3.0, 5.0, 9983.0, 12000.0)):
        Xv[k::7, 1] = v
    rt = lt.ServingRuntime(bp, device="cpu")
    assert rt._state.records.mw == 313
    np.testing.assert_array_equal(rt.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
