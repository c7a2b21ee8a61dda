"""The stacked traversal's records and launch plan (`compiler/records.py
stacked_records`, `stacked_plan`; kernel `csrc/stacked.cu`).

The kernel cannot run here, so `_record_walk` repeats its walk in torch
over the packed records: each step decodes one record (the threshold's
bits or a categorical node's word count, both children, the feature id
and the decision fields from one word) as the kernel does.  Its [T, N]
int32 slots must be bitwise the JAX package's `predict_leaf_ensemble`
(`lightgbm_tpu/ops/predict.py:632`) on the golden families, under every
missing type and default direction, and on categorical bitsets of 1, 3,
7 and 313 words.  On doctored planes (feature ids past F or negative,
node ids past NI, a cycle that meets the NI + 1 step bound) the JAX
package's gathers clamp and its while_loop does not end, so there the
oracle is the port's plain version, whose rules the kernel's contract
names.  The packer stores a feature id it cannot hold as the id that
reads 0.0, the plan covers every (tree, row) pair once, and records
are built only where the kernel runs and refused once their planes
change.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: E402
import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from chip_smoke import (adversarial_rows, doctored_planes,  # noqa: E402
                        wide_bitset_text)
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu.ops.predict import \
    predict_leaf_ensemble as jax_leaf_ensemble  # noqa: E402
from lightgbm_tpu_torch.compiler import records  # noqa: E402
from lightgbm_tpu_torch.compiler.records import (  # noqa: E402
    MAX_ROWS, STACKED_FEAT_OUT, stacked_plan, stacked_records)
from lightgbm_tpu_torch.ops.predict import (  # noqa: E402
    _ZERO_THRESHOLD, predict_leaf_ensemble_plain, records_current,
    stacked_to, with_records)

_JAX_LEAF = jax.jit(jax_leaf_ensemble)
_MAX_GRID_Y = 65535


def _text(name):
    return (ROOT / "tests" / "data" / f"golden_{name}.model.txt").read_text()


def _record_walk(rec, cat_words, X):
    """The kernel's walk over records `rec` [T, NI, 4] (and `cat_words`
    [T, NI, MW] or None) for rows X [N, F] f32: [T, N] int32 slots."""
    t_trees, ni, _ = rec.shape
    n, f = X.shape
    xt = X.t()
    zero = torch.zeros((), dtype=torch.float32)
    first, left, right, word = (rec[..., i] for i in range(4))
    nd = torch.zeros((t_trees, n), dtype=torch.int64)
    cols = torch.arange(n)[None, :].expand(t_trees, n)
    tree_ix = torch.arange(t_trees)[:, None]
    for _ in range(ni + 1):
        nd = torch.where(nd >= ni, -1, nd)
        act = nd >= 0
        if not bool(act.any()):
            break
        idx = torch.where(act, nd, 0)
        w = torch.gather(word, 1, idx)
        feat = (w & STACKED_FEAT_OUT).long()
        inside = feat < f
        fval = xt[torch.where(inside, feat, 0).clamp(max=max(f - 1, 0)),
                  cols] if f else zero.expand(feat.shape)
        fval = torch.where(inside, fval, zero)
        default_left = ((w >> 28) & 1) != 0
        missing_type = (w >> 29) & 3
        isnan = fval != fval
        fv = torch.where(isnan & (missing_type != 2), zero, fval)
        is_missing = (((missing_type == 1) & (fv.abs() <= _ZERO_THRESHOLD))
                      | ((missing_type == 2) & isnan))
        x0 = torch.gather(first, 1, idx)
        go_left = torch.where(is_missing, default_left,
                              fv <= x0.view(torch.float32))
        if cat_words is not None:
            mw = cat_words.shape[-1]
            span = (x0 * 32).to(torch.float32)      # int32, wrapping
            ok = ~isnan & (fval > -1.0) & (fval < span)
            v = torch.where(ok, fval, zero).to(torch.int32)
            widx = torch.clamp(v // 32, 0, mw - 1).long()
            cw = cat_words[tree_ix, idx, widx]
            bit = (cw >> (v % 32)) & 1
            go_left = torch.where(w < 0, ok & (bit == 1), go_left)
        child = torch.where(go_left, torch.gather(left, 1, idx),
                            torch.gather(right, 1, idx)).long()
        nd = torch.where(act, child, nd)
    return (~nd).to(torch.int32)


def _walk(stacked, X32):
    st = with_records(stacked)
    return _record_walk(st["rec"], st.get("cat_words"), X32)


def _both(text, X):
    """(record walk, reference) slots for the f64 rows X (f32 cast)."""
    bj = lgb.Booster(model_str=text)
    bp = lt.Booster(model_str=text)
    arrays = {k: v for k, v in bj.export_predict_arrays()["stacked"].items()
              if k not in ("min_features", "value")}
    with np.errstate(over="ignore"):
        X32 = X.astype(np.float32)
    want = np.asarray(_JAX_LEAF(arrays, X32))
    got = _walk(bp.export_predict_arrays()["stacked"], torch.from_numpy(X32))
    return got.numpy(), want


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_record_walk_bitwise_reference_on_golden_families(name):
    text = _text(name)
    X, _ = make_case_data(GOLDEN_CASES[name])
    trees = lt.Booster(model_str=text).trees
    rows = np.vstack([adversarial_rows(trees, X.shape[1], 0), X[:300]])
    got, want = _both(text, rows)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)


def _with_missing(text, missing_type, default_left):
    out = []
    for ln in text.splitlines():
        if ln.startswith("decision_type="):
            vals = [int(v) for v in ln.split("=", 1)[1].split()]
            ln = "decision_type=" + " ".join(
                str(v if v & 1 else (missing_type << 2)
                    | (2 if default_left else 0)) for v in vals)
        out.append(ln)
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("missing_type", [0, 1, 2])
@pytest.mark.parametrize("default_left", [False, True])
def test_record_walk_missing_types_and_default_direction(missing_type,
                                                         default_left):
    text = _with_missing(_text("regression_l2"), missing_type, default_left)
    trees = lt.Booster(model_str=text).trees
    rows = adversarial_rows(trees, 6, missing_type)
    rows[::3, :] = np.where(np.arange(6) % 2 == 0, np.nan, 0.0)
    rows[1::7, :] = -0.0
    rows[2::9, :] = 1e-38
    got, want = _both(text, rows)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("words", [(1, 1), (3, 3), (7, 2), (313, 2)])
def test_record_walk_categorical_bitsets(words):
    text = wide_bitset_text(_text("categorical"), words)
    trees = lt.Booster(model_str=text).trees
    rng = np.random.RandomState(sum(words))
    extra = rng.randn(600, 5)
    extra[:, 0] = rng.randint(-3, 32 * max(words) + 40, size=600)
    extra[::11, 0] = np.nan
    extra[5::13, 0] += 0.5
    got, want = _both(text, np.vstack([adversarial_rows(trees, 5, 1),
                                       extra]))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["binary", "categorical", "multiclass"])
def test_record_walk_doctored_planes_bitwise_plain(name):
    text = _text(name)
    bp = lt.Booster(model_str=text)
    X, _ = make_case_data(GOLDEN_CASES[name])
    rows = np.vstack([adversarial_rows(bp.trees, X.shape[1], 2), X[:200]])
    with np.errstate(over="ignore"):
        X32 = torch.from_numpy(rows.astype(np.float32))
    for seed in range(3):
        st = doctored_planes(bp.export_predict_arrays()["stacked"], seed)
        want = predict_leaf_ensemble_plain(st, X32)
        got = _walk(st, X32)
        assert torch.equal(got, want)


def test_record_walk_step_bound_gives_cursor():
    """A tree whose root loops on itself: after NI + 1 steps the cursor
    is still 0, and the slot is ~0 = -1 in both."""
    bp = lt.Booster(model_str=_text("binary"))
    st = dict(bp.export_predict_arrays()["stacked"])
    left = st["left"].clone()
    right = st["right"].clone()
    left[0, 0] = 0
    right[0, 0] = 0
    st.update(left=left, right=right)
    X32 = torch.zeros((5, 6), dtype=torch.float32)
    want = predict_leaf_ensemble_plain(st, X32)
    assert torch.equal(want[0], torch.full((5,), -1, dtype=torch.int32))
    assert torch.equal(_walk(st, X32), want)


def test_packer_fields_and_ids_it_cannot_hold():
    feat = np.array([[0, 5, STACKED_FEAT_OUT - 1, STACKED_FEAT_OUT,
                      STACKED_FEAT_OUT + 1, 2 ** 31 - 1, -1, -2 ** 31]],
                    np.int32)
    thr = np.linspace(-2, 2, 8, dtype=np.float32)[None]
    dtype = np.array([[0, 1, 2, 3, 4, 8, 14, 15]], np.int32)
    left = np.array([[1, -1, 7, 2 ** 31 - 1, -2 ** 31, 3, 0, 9]], np.int32)
    right = -left - 1
    nw = np.array([[0, 313, 0, 2 ** 27, 0, 0, 0, 5]], np.int32)
    for cat in (None, nw):
        rec = stacked_records(feat, thr, dtype, left, right, cat)
        assert rec.shape == (1, 8, 4) and rec.dtype == np.int32
        w = rec[..., 3].astype(np.int64) & 0xFFFFFFFF
        f = w & STACKED_FEAT_OUT
        assert f.tolist() == [[0, 5, STACKED_FEAT_OUT - 1] + [
            STACKED_FEAT_OUT] * 5]
        assert (((w >> 28) & 1) == ((dtype >> 1) & 1)).all()
        assert (((w >> 29) & 3) == ((dtype >> 2) & 3)).all()
        is_cat = (dtype & 1) != 0 if cat is not None else dtype * 0 != 0
        assert ((w >> 31) == is_cat).all()
        assert np.array_equal(rec[..., 1], left)
        assert np.array_equal(rec[..., 2], right)
        want0 = np.where(is_cat, nw, thr.view(np.int32))
        assert np.array_equal(rec[..., 0], want0)


def test_unheld_feature_ids_read_zero():
    """Ids the record cannot hold read +0.0 as the plain version's
    out-of-range ids do, at F = 1 .. 6."""
    bp = lt.Booster(model_str=_text("regression_l2"))
    st = dict(bp.export_predict_arrays()["stacked"])
    feat = st["feat"].clone()
    feat[:, 0] = STACKED_FEAT_OUT + 11
    feat[::2, 1] = -2 ** 31
    st["feat"] = feat
    rng = np.random.RandomState(4)
    for f in range(1, 7):
        X32 = torch.from_numpy(rng.randn(64, f).astype(np.float32))
        assert torch.equal(_walk(st, X32),
                           predict_leaf_ensemble_plain(st, X32))


def test_records_are_built_where_the_kernel_runs():
    """An export carries the reference's keys on every device; the
    records come from `with_records`, on the planes' device."""
    bp = lt.Booster(model_str=_text("categorical"))
    cpu = bp.export_predict_arrays()["stacked"]
    assert "rec" not in cpu
    assert "rec" not in bp.export_predict_arrays(device="meta")["stacked"]
    st = with_records(cpu)
    assert st["rec"].device.type == "cpu" and records_current(st)
    host = {k: cpu[k].numpy() for k in ("feat", "thr", "dtype", "left",
                                         "right")}
    assert np.array_equal(st["rec"].numpy(), stacked_records(
        **host, cat_nwords=cpu["cat_nwords"].numpy()))
    # a CPU runtime never launches the kernel, so it holds no records
    rt = lt.ServingRuntime(bp, device="cpu", compiled="off")
    assert rt.rung == "device_sum" and "rec" not in rt._state.dev.stacked


@pytest.mark.parametrize("plane", ["feat", "thr", "dtype", "left", "right",
                                   "cat_nwords"])
def test_stale_records_are_caught(plane):
    """Records stop being current once a plane they were built from is
    edited in place or replaced; a copy to a device keeps current ones
    current and stale ones stale."""
    bp = lt.Booster(model_str=_text("categorical"))
    st = with_records(dict(bp.export_predict_arrays()["stacked"]))
    moved = stacked_to(st, "cpu")
    assert records_current(moved)
    assert moved["rec"].data_ptr() != st["rec"].data_ptr()
    edited = dict(st, **{plane: st[plane].clone()})
    assert records_current(edited) is False
    edited[plane].add_(0)       # an in-place edit bumps its version
    assert records_current(with_records(edited))
    st[plane].add_(0)
    assert not records_current(st)
    assert not records_current(stacked_to(st, "cpu"))
    assert records_current(with_records(st))


def _plan_pairs(plan, b, t_trees):
    """Every (tree, row) the plan's grid writes, as the kernel's loops
    enumerate them: [pairs, 2] int64."""
    out = []
    chunks = min(plan.tree_chunks, _MAX_GRID_Y)
    threads = np.arange(plan.threads)
    shapes = {}

    def block(nrows, ntrees):        # a block's (tree, row) offsets
        if (nrows, ntrees) not in shapes:
            pairs = nrows * ntrees
            qs = []
            for p0 in range(0, pairs, plan.threads):
                q = p0 + threads
                qs.append(q[q < pairs])
            q = np.concatenate(qs)
            shapes[nrows, ntrees] = np.stack([q // nrows, q % nrows], 1)
        return shapes[nrows, ntrees]

    for bx in range(plan.row_blocks):
        row0 = bx * plan.rows
        nrows = min(plan.rows, b - row0)
        for by in range(chunks):
            for t0 in range(by * plan.trees, t_trees, chunks * plan.trees):
                out.append(block(nrows, min(plan.trees, t_trees - t0))
                           + np.array([t0, row0]))
    return np.concatenate(out)


@pytest.mark.parametrize("b", [1, 3, 256, 4096, 65536])
@pytest.mark.parametrize("f,t_trees", [(28, 500), (4097, 37), (70000, 3)])
def test_stacked_plan_covers_every_pair_once(b, f, t_trees):
    plan = stacked_plan(b, f, t_trees)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.rows <= MAX_ROWS and plan.row_blocks * plan.rows >= b
    if b * t_trees > 4_000_000:      # count, not enumerate
        assert (plan.row_blocks - 1) * plan.rows < b
        assert (plan.tree_chunks - 1) * plan.trees < t_trees
        return
    got = _plan_pairs(plan, b, t_trees)
    key = got[:, 0] * b + got[:, 1]
    assert len(key) == b * t_trees
    assert np.array_equal(np.sort(key), np.arange(b * t_trees))


@pytest.mark.parametrize("rows,trees", [(8, 3), (64, 1), (256, 5)])
@pytest.mark.parametrize("b", [3, 256, 4096])
def test_stacked_plan_covers_every_pair_once_on_request(b, rows, trees):
    plan = stacked_plan(b, 28, 500, rows=rows, trees=trees)
    key = _plan_pairs(plan, b, 500)
    key = key[:, 0] * b + key[:, 1]
    assert np.array_equal(np.sort(key), np.arange(b * 500))


def test_stacked_plan_spreads_a_row_and_takes_requests():
    one = stacked_plan(1, 28, 500)
    assert one.blocks >= records.TARGET_BLOCKS // 2
    # the rows are read from device memory, so no width cuts them
    assert stacked_plan(4096, 70000, 500).rows == \
        stacked_plan(4096, 28, 500).rows == records.STACKED_ROWS
    forced = stacked_plan(4096, 28, 500, rows=8, trees=3)
    assert (forced.rows, forced.trees) == (8, 3)
    with pytest.raises(ValueError):
        stacked_plan(4096, 28, 500, rows=3)
    with pytest.raises(ValueError):
        stacked_plan(0, 28, 500)
