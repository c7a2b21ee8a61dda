"""Training and prediction from data files, on the CPU, against the live
JAX package: `Dataset(path)` for CSV, TSV, space-separated and LibSVM
files, the column roles, whole-file and two_round ingest below and
above `bin_construct_sample_cnt`, validation files, `predict(path)`.
Bin matrices are the reference's, and model texts its byte for byte
(both packages train with `device_type="cpu"`, so both texts echo it).
Values are written with 17 significant digits, so the file parses back
to the array's doubles and a file's model is the array's model."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.cli import read_svmlight  # noqa: E402

CPU = {"device_type": "cpu", "verbosity": -1}
BASE = dict(CPU, objective="binary", num_leaves=7, min_data_in_leaf=10)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the sigmoid's bits (as in
    test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _data(n=2000, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n, f) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 1])
         + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _row(vals, sep):
    return sep.join("nan" if np.isnan(v) else "%.17g" % v for v in vals)


def _write_dense(path, X, y, sep=",", header=None):
    with open(path, "w") as fh:
        if header is not None:
            fh.write(header + "\n")
        for yi, row in zip(y, X):
            fh.write(_row(np.concatenate([[yi], row]), sep) + "\n")
    return str(path)


def _write_libsvm(path, X, y, zero_based=False):
    with open(path, "w") as fh:
        for yi, row in zip(y, X):
            cells = " ".join(f"{j + (0 if zero_based else 1)}:{float(v)!r}"
                             for j, v in enumerate(row) if v != 0)
            fh.write(f"{yi:g} {cells}\n")
    return str(path)


def _train_both(params, path, rounds=5, **kw):
    bj = lgb.train(params, lgb.Dataset(path), rounds, **kw)
    bp = lt.train(params, lt.Dataset(path), rounds, **kw)
    return bj, bp


FORMATS = {
    "csv": lambda p, X, y: _write_dense(p, X, y, ","),
    "tsv": lambda p, X, y: _write_dense(p, X, y, "\t"),
    "space": lambda p, X, y: _write_dense(p, X, y, " "),
    "csv_header": lambda p, X, y: _write_dense(
        p, X, y, ",", "label," + ",".join(f"f{j}" for j in range(5))),
    "libsvm": lambda p, X, y: _write_libsvm(p, np.nan_to_num(X), y),
    "libsvm_zero_based": lambda p, X, y: _write_libsvm(
        p, np.nan_to_num(X), y, zero_based=True),
}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_file_dataset_and_model_are_the_references(tmp_path, fmt):
    """Each format: the bins and labels the reference reads, the model
    text byte for byte, and the model the same array trains."""
    X, y = _data()
    if fmt.startswith("libsvm"):
        X = np.nan_to_num(X)
    path = FORMATS[fmt](tmp_path / f"d.{fmt}", X, y)
    dp = lt.Dataset(path, params=dict(CPU)).construct()
    dj = lgb.Dataset(path, params=dict(CPU)).construct()
    assert np.array_equal(dp.bin_data, np.asarray(dj.bin_data))
    assert np.array_equal(dp.get_label(), dj.get_label())
    bj, bp = _train_both(BASE, path)
    assert bp.model_to_string() == bj.model_to_string()
    from_array = lt.train(BASE, lt.Dataset(X, label=y), 5)
    assert bp.model_to_string() == from_array.model_to_string()


def _roles_file(path, header=False):
    """[weight, label, qid, junk, f0..f3]: the label is file column 1,
    the query id column 2 (group index 1: the indexes past the label do
    not count it), the junk column 3 (ignore index 2)."""
    rng = np.random.RandomState(13)
    n_query, docs = 40, 6
    n = n_query * docs
    X = rng.randn(n, 4)
    y = rng.randint(0, 3, n).astype(float)
    w = np.round(rng.rand(n) + 0.5, 3)
    qid = np.repeat(np.arange(n_query), docs)
    data = np.column_stack([w, y, qid, np.full(n, 7.0), X])
    with open(path, "w") as fh:
        if header:
            fh.write(",".join(str(i) for i in range(data.shape[1])) + "\n")
        for row in data:
            fh.write(_row(row, ",") + "\n")
    return str(path), X, y, w, np.full(n_query, docs)


ROLES = {"label_column": "1", "weight_column": "0", "group_column": "1",
         "ignore_column": "2"}


@pytest.mark.parametrize("ingest", [{}, {"two_round": True}])
@pytest.mark.parametrize("header", [False, True])
def test_column_roles_and_header(tmp_path, ingest, header):
    """label, weight, group (query ids to sizes) and ignored columns,
    with a declared numeric header line or none, both ingest routes:
    the reference's fields and lambdarank model."""
    path, X, y, w, sizes = _roles_file(tmp_path / "roles.csv", header)
    params = dict(CPU, **ROLES, **ingest, header=header)
    dp = lt.Dataset(path, params=params).construct()
    dj = lgb.Dataset(path, params=params).construct()
    assert dp.num_feature() == 4 and dp.num_data() == len(y)
    assert np.array_equal(dp.get_label(), y.astype(np.float32))
    assert np.array_equal(dp.get_weight(), w.astype(np.float32))
    assert np.array_equal(dp.get_group(), sizes)
    assert np.array_equal(dp.bin_data, np.asarray(dj.bin_data))
    rank = dict(params, objective="lambdarank", num_leaves=7,
                min_data_in_leaf=5)
    bj, bp = _train_both(rank, path, rounds=3)
    assert bp.model_to_string() == bj.model_to_string()


def test_column_spec_by_name_raises(tmp_path):
    path, *_ = _roles_file(tmp_path / "roles.csv")
    with pytest.raises(lt.LightGBMError, match="name:"):
        lt.Dataset(path, params={"label_column": "name:y"}).construct()


@pytest.mark.parametrize("sample_cnt", [5000, 1000])
def test_two_round_below_and_above_the_sample_count(tmp_path, sample_cnt):
    """3,000 rows: below `bin_construct_sample_cnt` two_round sees every
    row and its bins are the whole-file route's; above it the reservoir
    draws another sample, and the port's two_round set and model are
    the reference's two_round ones byte for byte."""
    X, y = _data(3000, 5, seed=3)
    path = _write_dense(tmp_path / "d.csv", X, y)
    two = dict(CPU, two_round=True, bin_construct_sample_cnt=sample_cnt)
    dp = lt.Dataset(path, params=two).construct()
    dj = lgb.Dataset(path, params=two).construct()
    whole = lt.Dataset(path, params=dict(
        CPU, bin_construct_sample_cnt=sample_cnt)).construct()
    assert isinstance(dp.data, str)          # never read whole
    assert np.array_equal(dp.bin_data, np.asarray(dj.bin_data))
    assert [m.to_dict() for m in dp.bin_mappers] == \
        [m.to_dict() for m in dj.bin_mappers]
    assert np.array_equal(dp.bin_data, whole.bin_data) == \
        (sample_cnt >= 3000)
    bj, bp = _train_both(dict(BASE, **two), path)
    assert bp.model_to_string() == bj.model_to_string()


def test_two_round_numeric_header_and_fallbacks(tmp_path):
    """A declared numeric header dropped by two_round as by the
    whole-file route; a LibSVM file and a text cell mid-file take the
    whole-file route (genfromtxt for the text cell, with the reference's
    warning), as in the reference."""
    X, y = _data(600, 4, seed=5)
    path = _write_dense(tmp_path / "h.csv", X, y, header="0,1,2,3,4")
    a = lt.Dataset(path, params={"two_round": True, "header": True})
    b = lt.Dataset(path, params={"header": True})
    assert np.array_equal(a.construct().bin_data, b.construct().bin_data)
    assert a.num_data() == 600
    svm = _write_libsvm(tmp_path / "d.svm", np.nan_to_num(X), y)
    assert np.array_equal(
        lt.Dataset(svm, params={"two_round": True}).construct().bin_data,
        np.asarray(lgb.Dataset(svm).construct().bin_data))
    text = tmp_path / "text.csv"
    lines = Path(path).read_text().splitlines()[1:]
    lines[300] = lines[300].replace(lines[300].split(",")[2], "abc", 1)
    text.write_text("\n".join(lines) + "\n")
    for params in ({}, {"two_round": True}):
        dp = lt.Dataset(str(text), params=dict(params)).construct()
        dj = lgb.Dataset(str(text), params=dict(params)).construct()
        assert np.array_equal(dp.bin_data, np.asarray(dj.bin_data))
        assert dp.num_data() == 600


def test_libsvm_with_qid_reads_as_the_reference(tmp_path):
    """`qid:` tokens, which the strict parser refuses, through the port's
    copy of scikit-learn's rules: the reference's array, bins and model;
    unsorted indices raise where scikit-learn raises."""
    X, y = _data(400, 4, seed=9)
    X = np.nan_to_num(X)
    path = tmp_path / "q.svm"
    with open(path, "w") as fh:
        for i, (yi, row) in enumerate(zip(y, X)):
            cells = " ".join(f"{j + 1}:{float(v)!r}" for j, v in enumerate(row))
            fh.write(f"{yi:g} qid:{i // 10} {cells}  # row {i}\n")
    from sklearn.datasets import load_svmlight_file
    Xs, ys = load_svmlight_file(str(path))
    Xp, yp = read_svmlight(str(path))
    assert np.array_equal(Xp, np.asarray(Xs.todense())) and \
        np.array_equal(yp, ys)
    assert np.array_equal(Xp, X)
    bj, bp = _train_both(BASE, str(path))
    assert bp.model_to_string() == bj.model_to_string()
    bad = tmp_path / "bad.svm"
    bad.write_text("1 qid:1 3:1 2:2\n")
    with pytest.raises(ValueError):
        load_svmlight_file(str(bad))
    with pytest.raises(ValueError):
        lt.Dataset(str(bad)).construct()


def test_validation_files(tmp_path):
    """A validation file through `create_valid` and through
    `Dataset(path, reference=train)`: the training mappers, the
    reference's eval log and model."""
    X, y = _data(1500, 5, seed=11)
    Xv, yv = _data(500, 5, seed=12)
    train = _write_dense(tmp_path / "train.csv", X, y)
    valid = _write_dense(tmp_path / "valid.csv", Xv, yv)
    params = dict(BASE, metric=["binary_logloss", "auc"])
    logs = []
    for m in (lgb, lt):
        dtr = m.Dataset(train)
        sets = [dtr.create_valid(valid), m.Dataset(valid, reference=dtr)]
        ev = {}
        bst = m.train(params, dtr, 5, valid_sets=sets,
                      valid_names=["a", "b"],
                      callbacks=[m.record_evaluation(ev)])
        assert sets[0].bin_mappers is dtr.bin_mappers
        logs.append((ev, bst.model_to_string(),
                     np.asarray(sets[1].bin_data)))
    assert logs[0][1] == logs[1][1]
    assert np.array_equal(logs[0][2], logs[1][2])
    for name in ("a", "b"):
        for metric in ("binary_logloss", "auc"):
            assert np.allclose(logs[0][0][name][metric],
                               logs[1][0][name][metric], rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("fmt", ["csv", "csv_header", "libsvm"])
def test_predict_from_a_file(tmp_path, fmt):
    """`predict(path)` with the label column present and dropped: the
    reference's scores, and the port's scores of the array, bit for bit;
    raw and converted, leaves and `device_predict`'s plain versions."""
    X, y = _data(800, 5, seed=21)
    if fmt == "libsvm":
        X = np.nan_to_num(X)
    path = FORMATS[fmt](tmp_path / f"p.{fmt}", X, y)
    bj, bp = _train_both(BASE, path, rounds=6)
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True}):
        got = bp.predict(path, **kw)
        assert np.array_equal(got, bj.predict(path, **kw))
        assert np.array_equal(got, bp.predict(X, **kw))
    dev = bp.predict(path, device_predict=True, device_type="cpu")
    assert np.array_equal(dev, bp.predict(X, device_predict=True,
                                          device_type="cpu"))
    if fmt == "csv":
        # data_has_header declares the header the sniff would miss
        numeric = tmp_path / "numeric_header.csv"
        numeric.write_text("0,1,2,3,4,5\n" + Path(path).read_text())
        assert np.array_equal(bp.predict(str(numeric), data_has_header=True),
                              bp.predict(X))


def test_init_model_continues_a_two_round_set(tmp_path):
    """A two_round set keeps its path as its data, so continued training
    predicts the init model on the file: the reference's model."""
    X, y = _data(1200, 5, seed=31)
    path = _write_dense(tmp_path / "c.csv", X, y)
    params = dict(BASE, two_round=True)
    texts = []
    for m in (lgb, lt):
        first = m.train(params, m.Dataset(path), 3)
        texts.append(m.train(params, m.Dataset(path), 3,
                             init_model=first).model_to_string())
    assert texts[0] == texts[1]
