"""The Dataset's inputs, its binary cache and the rest of its surface
against the JAX package, on the CPU.

  * pandas with NaN, Arrow with nulls, a `Sequence` (and a list of
    them), CSR and CSC with explicit zeros and NaN: bin mappers, bin
    codes (the dense [N, F] matrix or, when EFB bundles sparse input,
    the binned CSC and the [N, G] bundle matrix, `bin_data` None) and
    bundles equal to the reference's, then model texts byte for byte;
    the sparse form's model is the dense form's;
  * sparse validation sets and subsets, also with query groups;
  * `save_binary` written by either package and read by the other:
    the same bins, fields and model;
  * `Booster.predict` on sparse, pandas and Arrow rows;
  * the Dataset surface: set/get of label, weight, group, init_score,
    position and the fields, feature names, categorical features,
    `feature_num_bin`, `num_total_data`, `set_reference`,
    `get_ref_chain`, `add_features_from`, `get_params`.
Mirrors tests/test_sparse_ingest.py.
"""
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import scipy.sparse as sps
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "device_type": "cpu", "min_data_in_leaf": 5}


def _sparse(n=600, f=40, density=0.05, seed=5, fmt="csr"):
    rng = np.random.RandomState(seed)
    m = sps.random(n, f, density=density, format="csr", random_state=rng,
                   dtype=np.float64)
    # explicit zeros and NaN among the stored values
    m.data[::17] = 0.0
    m.data[::23] = np.nan
    y = (np.nan_to_num(np.asarray(m.sum(axis=1)).ravel())
         + 0.1 * rng.randn(n) > 0.5 * f * density * 0.5).astype(float)
    return (m if fmt == "csr" else m.tocsc()), y


def _dense_frame(n=400, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[rng.rand(n, 5) < 0.1] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _assert_same_binning(dp, dj):
    assert [m.to_dict() for m in dp.bin_mappers] == \
        [m.to_dict() for m in dj.bin_mappers]
    assert dp.get_feature_name() == dj.get_feature_name()
    if dj.bin_data is None:
        assert dp.bin_data is None
        sp_, sj = dp.sparse_binned, dj.sparse_binned
        assert np.array_equal(sp_.indptr, sj.indptr)
        assert np.array_equal(sp_.indices, sj.indices)
        assert np.array_equal(sp_.data, sj.data)
    else:
        assert np.array_equal(dp.bin_data, np.asarray(dj.bin_data))
    assert (dp.efb is None) == (dj.efb is None)
    if dj.efb is not None:
        assert dp.efb.to_dict() == dj.efb.to_dict()
        assert np.array_equal(dp.bundle_data, np.asarray(dj.bundle_data))


def _text(m, data, y, params=PARAMS, rounds=3, **kw):
    return m.train(dict(params), m.Dataset(data, label=y, **kw),
                   rounds).model_to_string()


class _Rows(lt.Sequence):
    def __init__(self, X, batch_size):
        self.X = X
        self.batch_size = batch_size

    def __len__(self):
        return len(self.X)

    def __getitem__(self, idx):
        return self.X[idx]


class _RefRows(lgb.basic.Sequence):
    def __init__(self, X, batch_size):
        self.X = X
        self.batch_size = batch_size

    def __len__(self):
        return len(self.X)

    def __getitem__(self, idx):
        return self.X[idx]


def _inputs(kind):
    X, y = _dense_frame()
    if kind == "pandas":
        df = pd.DataFrame(X, columns=[f"f{i}" for i in range(5)])
        return df, df.copy(), y
    if kind == "arrow":
        cols = {f"a{i}": pa.array(np.where(np.isnan(X[:, i]), None,
                                           X[:, i]).tolist(),
                                  type=pa.float64()) for i in range(5)}
        t = pa.table(cols)
        return t, t, y
    if kind == "sequence":
        return _Rows(X, 64), _RefRows(X, 64), y
    if kind == "sequences":
        return [_Rows(X[:150], 32), _Rows(X[150:], 100)], \
            [_RefRows(X[:150], 32), _RefRows(X[150:], 100)], y
    m, y = _sparse(fmt=kind)
    return m, m.copy(), y


KINDS = ["pandas", "arrow", "sequence", "sequences", "csr", "csc"]


@pytest.mark.parametrize("kind", KINDS)
def test_inputs_bin_and_train_as_the_reference(kind):
    dport, dref, y = _inputs(kind)
    dp = lt.Dataset(dport, label=y).construct()
    dj = lgb.Dataset(dref, label=y).construct()
    _assert_same_binning(dp, dj)
    if kind in ("csr", "csc"):
        assert dp.bin_data is None and dp.efb is not None
    dport, dref, y = _inputs(kind)
    assert _text(lt, dport, y) == _text(lgb, dref, y)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_model_is_the_dense_model(fmt):
    m, y = _sparse(fmt=fmt)
    assert _text(lt, m, y) == _text(lt, m.toarray(), y)
    X = _sparse(seed=6)[0]
    bst = lt.train(dict(PARAMS), lt.Dataset(m, label=y), 3)
    assert np.array_equal(bst.predict(X), bst.predict(X.toarray()))


def test_predict_on_pandas_and_arrow_rows():
    X, y = _dense_frame()
    bst = lt.train(dict(PARAMS), lt.Dataset(X, label=y), 3)
    want = bst.predict(X)
    df = pd.DataFrame(X)
    t = pa.table({f"c{i}": pa.array(np.where(np.isnan(X[:, i]), None,
                                             X[:, i]).tolist(),
                                    type=pa.float64()) for i in range(5)})
    assert np.array_equal(bst.predict(df), want)
    assert np.array_equal(bst.predict(t), want)
    assert np.array_equal(bst.predict(sps.csr_matrix(np.nan_to_num(X))),
                          bst.predict(np.nan_to_num(X)))


def test_sparse_valid_sets_and_subsets():
    m, y = _sparse()
    mv, yv = _sparse(seed=9)
    out = []
    for mod in (lgb, lt):
        ds = mod.Dataset(m.copy(), label=y)
        bst = mod.Booster(dict(PARAMS, metric="auc"), ds)
        valid = ds.create_valid(mv.copy(), label=yv)
        bst.add_valid(valid, "v")
        for _ in range(3):
            bst.update()
        sub = ds.subset(np.arange(0, 600, 3)).construct()
        out.append((bst.model_to_string(), bst.eval_valid(),
                    valid, sub))
    (tj, ej, vj, sj), (tp, ep, vp, sp_) = out
    assert tp == tj and ep == ej
    _assert_same_binning(vp, vj)
    assert sp_.bin_data is None
    _assert_same_binning(sp_, sj)
    assert np.array_equal(sp_.get_label(), sj.get_label())


def test_subsets_keep_whole_queries():
    X, y = _dense_frame(n=300)
    sizes = [10] * 30
    dp = lt.Dataset(X, label=y, group=sizes).construct()
    dj = lgb.Dataset(X, label=y, group=sizes).construct()
    idx = np.concatenate([np.arange(20, 40), np.arange(100, 110),
                          np.arange(205, 212)])
    sp_, sj = dp.subset(idx).construct(), dj.subset(idx).construct()
    assert np.array_equal(sp_.get_group(), sj.get_group())
    assert list(sp_.get_group()) == [10, 10, 10, 5, 2]


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_binary_is_read_by_either_package(kind, writer, tmp_path):
    if kind == "sparse":
        data, y = _sparse()
    else:
        data, y = _dense_frame()
    sizes = [20] * (len(y) // 20)
    pos = np.tile(np.arange(20), len(sizes))
    w = np.linspace(0.5, 1.5, len(y))
    path = str(tmp_path / "d.bin")
    src = (lt if writer == "port" else lgb).Dataset(
        data, label=y, weight=w, group=sizes, position=pos).construct()
    src.save_binary(path)
    dp = lt.Dataset.load_binary(path)
    dj = lgb.Dataset.load_binary(path)
    _assert_same_binning(dp, dj)
    for a, b in ((dp.get_label(), dj.get_label()),
                 (dp.get_weight(), dj.get_weight()),
                 (dp.get_group(), dj.get_group()),
                 (dp.get_position(), dj.get_position())):
        assert np.array_equal(a, b)
    params = dict(PARAMS, objective="lambdarank")
    tj = lgb.train(dict(params), dj, 3).model_to_string()
    tp = lt.train(dict(params), dp, 3).model_to_string()
    assert tp == tj
    fresh = lt.train(dict(params), lt.Dataset(
        data, label=y, weight=w, group=sizes, position=pos), 3)
    assert fresh.model_to_string() == tp


def test_dataset_surface():
    X, y = _dense_frame()
    n = len(y)
    ds = lt.Dataset(X, label=y, feature_name=list("abcde")).construct()
    assert ds.num_total_data() == n and ds.feature_num_bin("b") > 2
    assert ds.feature_num_bin(1) == ds.bin_mappers[1].num_bin
    ds.set_label(1 - y)
    assert np.array_equal(ds.get_field("label"), (1 - y).astype(np.float32))
    ds.set_field("weight", np.ones(n))
    assert ds.get_weight().dtype == np.float32
    ds.set_group([n // 2, n - n // 2])
    assert list(ds.get_group()) == [n // 2, n - n // 2]
    ds.set_group(np.repeat([7, 8, 9], [100, 100, n - 200]))   # query ids
    assert list(ds.get_field("group")) == [100, 100, n - 200]
    ds.set_position(np.arange(n) % 10)
    assert ds.get_position().dtype == np.int32
    ds.set_init_score(np.zeros(n))
    assert ds.get_field("init_score").shape == (n,)
    assert ds.get_field("bogus") is None
    ds.set_feature_name(list("vwxyz"))
    assert ds.get_feature_name() == list("vwxyz")
    with pytest.raises(lt.LightGBMError, match="feature_name"):
        ds.set_feature_name(["a"])
    with pytest.raises(lt.LightGBMError, match="categorical"):
        ds.set_categorical_feature([0])
    with pytest.raises(lt.LightGBMError, match="group"):
        ds.set_group([3, 4])
    assert ds.get_params() == {} and ds.version > 0
    valid = lt.Dataset(X[:50], label=y[:50]).set_reference(ds)
    assert ds in valid.get_ref_chain() and len(valid.get_ref_chain()) == 2
    valid.construct()
    assert valid.bin_mappers is ds.bin_mappers
    other = lt.Dataset(X[:, :2] * 2, label=y).construct()
    ds.add_features_from(other)
    assert ds.num_feature() == 7 and ds.efb is None
    ref = lgb.Dataset(X, label=y).construct()
    ref.add_features_from(lgb.Dataset(X[:, :2] * 2, label=y).construct())
    assert np.array_equal(ds.bin_data, np.asarray(ref.bin_data))
