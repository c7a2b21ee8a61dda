"""The port's Dataset against the JAX package's, on the CPU.

Both packages bin the same numpy matrices with the same params: the bin
matrix, every mapper's bin count, upper bounds, missing type and default
bin, and the EFB decision (None or the same BundleSpec) must be equal
bitwise.  Inputs: the five golden families, a matrix with NaNs, constant
and all-zero columns, a sampled construction (bin_construct_sample_cnt
below the row count), a wide-bin (uint16) matrix, and a sparse matrix on
which the bundle search does find bundles.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu_torch.interop import dataset_from_numpy  # noqa: E402


def _special_matrix(seed=5):
    """NaNs, a constant column, an all-zero column, zeros mixed in."""
    rng = np.random.RandomState(seed)
    X = rng.randn(3000, 7)
    X[rng.rand(3000) < 0.1, 0] = np.nan
    X[:, 1] = 3.25                           # constant
    X[:, 2] = 0.0                            # all zero
    X[rng.rand(3000) < 0.4, 3] = 0.0         # many zeros
    X[:, 4] = np.round(X[:, 4] * 2)          # few distinct values
    X[rng.rand(3000) < 0.02, 5] = np.nan
    return X


def _sparse_matrix(seed=6):
    """Mutually exclusive sparse columns: EFB bundles them."""
    rng = np.random.RandomState(seed)
    n, f = 4000, 8
    X = np.zeros((n, f))
    owner = rng.randint(0, f, n)
    X[np.arange(n), owner] = rng.rand(n) + 0.5
    X[rng.rand(n) < 0.5] = 0.0
    return X


def _cases():
    out = []
    for name in sorted(GOLDEN_CASES):
        case = GOLDEN_CASES[name]
        X, y = make_case_data(case)
        kw = {}
        if case.get("categorical"):
            kw["categorical_feature"] = case["categorical"]
        out.append((name, X, y, {"verbosity": -1}, kw))
    X = _special_matrix()
    out.append(("special", X, np.zeros(len(X)), {"verbosity": -1}, {}))
    out.append(("sampled", X, np.zeros(len(X)),
                {"verbosity": -1, "bin_construct_sample_cnt": 700,
                 "data_random_seed": 11}, {}))
    rng = np.random.RandomState(7)
    Xw = rng.randn(5000, 3)
    out.append(("wide_bins", Xw, np.zeros(len(Xw)),
                {"verbosity": -1, "max_bin": 1023, "min_data_in_bin": 1},
                {}))
    Xs = _sparse_matrix()
    out.append(("sparse", Xs, np.zeros(len(Xs)), {"verbosity": -1}, {}))
    return out


CASES = _cases()


def _pair(X, y, params, kw):
    dj = lgb.Dataset(X, label=y, params=dict(params), **kw).construct()
    dp = lt.Dataset(X, label=y, params=dict(params), **kw).construct()
    return dj, dp


def _assert_same_binning(dj, dp):
    bj = np.asarray(dj.bin_data)
    assert dp.bin_data.dtype == bj.dtype
    assert np.array_equal(dp.bin_data, bj)
    assert len(dp.bin_mappers) == len(dj.bin_mappers)
    for mj, mp in zip(dj.bin_mappers, dp.bin_mappers):
        assert mp.num_bin == mj.num_bin
        assert mp.missing_type == mj.missing_type
        assert mp.default_bin == mj.default_bin
        assert mp.bin_type == mj.bin_type
        assert mp.is_trivial == mj.is_trivial
        assert np.array_equal(
            np.asarray(mp.bin_upper_bound).view(np.uint64),
            np.asarray(mj.bin_upper_bound).view(np.uint64))
        assert mp.feature_info_str() == mj.feature_info_str()


@pytest.mark.parametrize("name,X,y,params,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_bins_mappers_and_bundles_match(name, X, y, params, kw):
    dj, dp = _pair(X, y, params, kw)
    _assert_same_binning(dj, dp)
    assert dp.num_data() == dj.num_data()
    assert dp.num_feature() == dj.num_feature()
    assert np.array_equal(dp.get_label(), dj.get_label())
    if dj.efb is None:
        assert dp.efb is None
    else:
        assert dp.efb is not None
        assert dp.efb.to_dict() == dj.efb.to_dict()
    if name == "sparse":
        assert dp.efb is not None, "the sparse case must exercise bundles"
    if name == "wide_bins":
        assert dp.bin_data.dtype == np.uint16


def test_create_valid_bins_with_the_training_mappers():
    X = _special_matrix()
    rng = np.random.RandomState(3)
    Xv = rng.randn(500, X.shape[1]) * 2
    Xv[rng.rand(500) < 0.1, 0] = np.nan
    dj = lgb.Dataset(X, label=np.zeros(len(X)))
    dp = lt.Dataset(X, label=np.zeros(len(X)))
    vj = dj.create_valid(Xv, label=np.ones(500)).construct()
    vp = dp.create_valid(Xv, label=np.ones(500)).construct()
    assert vp.bin_mappers is dp.bin_mappers
    assert np.array_equal(vp.bin_data, np.asarray(vj.bin_data))
    assert np.array_equal(vp.get_label(), np.ones(500, np.float32))


def test_weight_label_and_shape_checks():
    X = np.random.RandomState(0).randn(100, 3)
    w = np.linspace(0.5, 1.5, 100)
    ds = lt.Dataset(X, label=np.arange(100) % 2, weight=w).construct()
    assert ds.get_weight().dtype == np.float32
    assert np.array_equal(ds.get_weight(), w.astype(np.float32))
    with pytest.raises(lt.LightGBMError, match="label"):
        lt.Dataset(X, label=np.zeros(99)).construct()
    with pytest.raises(lt.LightGBMError, match="number of features"):
        lt.Dataset(X).create_valid(X[:, :2]).construct()


def test_inputs_of_later_slices_raise(tmp_path):
    """A file path constructs since item 5i and external memory spills
    since item 5e's first half (tests/test_torch_file_input.py,
    tests/test_torch_datastore.py); groups, sparse, pandas, Arrow and
    the binary cache train since item 5d (tests/test_torch_inputs.py).
    Since item 5e's second half a spilled set whose bins exceed
    `datastore_budget_mb` trains under `streaming_train=auto` on the
    shard-streamed grower (tests/test_torch_streaming.py), and its store
    stays unassembled."""
    X = np.random.RandomState(0).randn(300, 2)
    y = (X[:, 0] > 0).astype(float)
    path = str(tmp_path / "train.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    dp = lt.Dataset(path).construct()
    assert np.array_equal(dp.bin_data,
                          np.asarray(lgb.Dataset(path).construct().bin_data))
    spilled = lt.Dataset(X, label=y, params={"external_memory": True,
                                             "datastore_budget_mb": 1e-4})
    assert spilled.construct().bin_data is None
    bst = lt.train({"objective": "binary", "verbosity": -1,
                    "device_type": "cpu", "external_memory": True,
                    "datastore_budget_mb": 1e-4}, spilled, 1)
    assert bst._streaming is not None and bst.num_trees() == 1
    assert spilled.bin_data is None and bst._dd._bins_fm is None


def test_dataset_from_numpy_carries_jax_bins_over():
    X, y = make_case_data(GOLDEN_CASES["binary"])
    dj = lgb.Dataset(X, label=y).construct()
    dp = dataset_from_numpy(np.asarray(dj.bin_data),
                            [m.to_dict() for m in dj.bin_mappers],
                            label=dj.get_label())
    _assert_same_binning(dj, dp)
    assert dp.efb is None
    assert dp.get_feature_name() == dj.get_feature_name()


def test_dataset_from_numpy_carries_queries_and_positions_over():
    """`group=` and `position=` bring a constructed JAX Dataset's queries
    and positions across with its bins; a lambdarank model trained on
    the carried set is the one trained on the port's own binning."""
    rng = np.random.RandomState(3)
    sizes = [12] * 20
    X = rng.randn(sum(sizes), 5)
    y = np.clip(np.round(X[:, 0] + 1 + 0.5 * rng.randn(len(X))), 0, 3)
    pos = np.tile(np.arange(12), 20)
    dj = lgb.Dataset(X, label=y, group=sizes, position=pos).construct()
    dp = dataset_from_numpy(np.asarray(dj.bin_data),
                            [m.to_dict() for m in dj.bin_mappers],
                            label=dj.get_label(), group=dj.get_group(),
                            position=dj.get_position())
    assert np.array_equal(dp.get_group(), dj.get_group())
    assert np.array_equal(dp._query_boundaries, dj._query_boundaries)
    assert np.array_equal(dp.get_position(), dj.get_position())
    params = {"objective": "lambdarank", "num_leaves": 7, "verbosity": -1,
              "device_type": "cpu"}
    own = lt.train(params, lt.Dataset(X, label=y, group=sizes,
                                      position=pos), 2)
    carried = lt.train(params, dp, 2)
    assert carried.model_to_string() == own.model_to_string()
