"""The port's host library (`lightgbm_tpu_torch/native/`) against its
plain numpy versions and against the JAX package's own library, on the
CPU: every entry bit for bit (parsed arrays with their NaNs, bin codes,
f64 raw scores), and a build that fails raises."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu.native as ref_native  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu.utils.binning import BinMapper as RefMapper  # noqa: E402
from lightgbm_tpu_torch import native  # noqa: E402
from lightgbm_tpu_torch.utils.binning import BinMapper  # noqa: E402

DATA = ROOT / "tests" / "data"


def _same(a, b):
    """Equal arrays, NaN for NaN, same shape and dtype."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _write(path, text):
    path.write_text(text)
    return str(path)


# ------------------------------------------------------------------ parsing
DENSE = {
    "csv": "1.5,2,3\n-4,5e-3,6\n7,8,9\n",
    "tsv": "1.5\t2\t3\n-4\t5e-3\t6\n",
    "space": "1.5 2 3\n-4 5e-3 6\n",
    "header": "a,b,c\n1,2,3\n4,5,6\n",
    "numeric_header": "0,1,2\n1,2,3\n4,5,6\n",
    "empty_and_nan_cells": "1,,3\nna,NaN,?\n\"4\",  5 ,nan\n,,\n",
    "crlf_and_blank_lines": "1,2\r\n\r\n3,4\r\n\n5,6",
    "trailing_delimiter": "1,2,\n3,4,\n",
    "specials": "inf,-inf,1e400\n-0,0x1p-3,5e-324\n1e-35,-1e-35,+7\n",
    "long_digits": "0.10000000149011612,-1.2345678901234567e-08\n"
                   "3.4028234663852886e+38,2.2250738585072014e-308\n",
}
#: files the dense parser refuses (ValueError): a text cell mid-file, a
#: row of another width
DENSE_BAD = {"text_mid_file": "1,2\n3,x\n", "ragged": "1,2\n3,4,5\n"}


@pytest.mark.parametrize("name", list(DENSE))
def test_parse_dense_against_plain_and_reference(tmp_path, name):
    p = _write(tmp_path / f"{name}.txt", DENSE[name])
    got, header = native.parse_dense(p)
    plain, plain_header = native.parse_dense_plain(p)
    ref, ref_header = ref_native.parse_dense(p)
    assert header == plain_header == ref_header == (name == "header")
    assert _same(got, plain) and _same(got, ref)
    # the integer bits too: -0.0, NaN payloads, subnormals
    assert np.array_equal(got.view(np.int64), ref.view(np.int64))


@pytest.mark.parametrize("name", list(DENSE_BAD))
def test_parse_dense_refuses_as_reference(tmp_path, name):
    p = _write(tmp_path / f"{name}.txt", DENSE_BAD[name])
    for fn in (native.parse_dense, native.parse_dense_plain,
               ref_native.parse_dense):
        with pytest.raises(ValueError):
            fn(p)


LIBSVM = {
    "one_based": "1.5 1:0.5 3:2.0\n-1 2:1.25\n0 1:1 2:2 3:3\n",
    "zero_based": "1 0:7.0 2:2.0\n0 1:1.25\n",
    "comments_tabs_blank": "1\t2:3 # note\n\n  0 1:-1e-3\t4:2\r\n",
    "label_only_and_unsorted": "3\n1 5:1 2:2 5:9\n",
}
#: files the strict LibSVM parser refuses
LIBSVM_BAD = {"qid": "1 qid:3 1:0.5\n0 qid:3 2:1\n",
              "no_colon": "1 1:2 3\n", "bad_value": "1 1:x\n",
              "bad_label": "a 1:2\n"}


@pytest.mark.parametrize("name", list(LIBSVM))
def test_parse_libsvm_against_plain_and_reference(tmp_path, name):
    p = _write(tmp_path / f"{name}.svm", LIBSVM[name])
    got = native.parse_libsvm(p)
    assert _same(got, native.parse_libsvm_plain(p))
    assert _same(got, ref_native.parse_libsvm(p))


@pytest.mark.parametrize("name", list(LIBSVM_BAD))
def test_parse_libsvm_refuses_as_reference(tmp_path, name):
    p = _write(tmp_path / f"{name}.svm", LIBSVM_BAD[name])
    for fn in (native.parse_libsvm, native.parse_libsvm_plain,
               ref_native.parse_libsvm):
        with pytest.raises(ValueError):
            fn(p)


def test_stream_reader_chunks_equal_the_whole_file(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(1000, 5)
    X[::13, 3] = np.nan
    p = str(tmp_path / "d.csv")
    with open(p, "w") as fh:
        fh.write("a,b,c,d,e\n")
        for row in X:
            fh.write(",".join(repr(float(v)) for v in row) + "\n")
    whole, header = native.parse_dense(p)
    assert header and _same(whole, native.parse_dense_plain(p)[0])
    assert np.array_equal(whole, X, equal_nan=True)   # repr round-trips
    for chunk_rows in (1, 128, 999, 1000, 4096):
        r = native.StreamReader(p, chunk_rows=chunk_rows)
        assert r.n_cols == 5 and r.had_header
        chunks = [c.copy() for c in r]
        assert all(len(c) <= chunk_rows for c in chunks)
        assert _same(np.concatenate(chunks), whole)
    refs = [c.copy() for c in ref_native.StreamReader(p, chunk_rows=128)]
    assert _same(np.concatenate(refs), whole)


def test_stream_reader_refuses(tmp_path):
    p = _write(tmp_path / "bad.csv", "1,2\n3,4\n5,x\n")
    r = native.StreamReader(p, chunk_rows=2)
    assert r.next_chunk() is not None
    with pytest.raises(ValueError):
        r.next_chunk()
    with pytest.raises(ValueError):
        native.StreamReader(_write(tmp_path / "empty.csv", "\n\n"))


# -------------------------------------------------------------- bin mapping
#: values at the edges of the search: NaN, infinities, signed zeros, the
#: zero bin's bounds, subnormals
EDGES = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-35, -1e-35,
                  np.nextafter(1e-35, 1), np.nextafter(-1e-35, -1),
                  5e-324, -5e-324, 1e308, -1e308])


def _mapper(cls, missing, nbins):
    """A mapper of each package fitted on the same sample: with NaNs
    (missing NaN), zero as missing (missing zero), or neither; `nbins`
    distinct values give the u8 or the u16 range."""
    rng = np.random.RandomState(nbins)
    vals = np.round(rng.randn(20000), 3 if nbins > 256 else 1)
    vals[::50] = 0.0
    if missing == "nan":
        vals[::37] = np.nan
    m = cls()
    m.find_bin(vals, len(vals), nbins, min_data_in_bin=1, bin_type=0,
               use_missing=True, zero_as_missing=missing == "zero")
    return m


@pytest.mark.parametrize("nbins", [63, 255, 1023])
@pytest.mark.parametrize("missing", ["none", "zero", "nan"])
def test_values_to_bins_against_plain_and_reference(missing, nbins):
    """The library against its plain version and the JAX package's
    library at every bound (exactly on it, and one ulp either side) and
    the edge values, for each missing type, u8 and u16."""
    m, r = _mapper(BinMapper, missing, nbins), _mapper(RefMapper, missing,
                                                       nbins)
    assert np.array_equal(m.bin_upper_bound, r.bin_upper_bound)
    assert m.missing_type == r.missing_type
    assert (m.num_bin > 256) == (nbins > 256)
    b = m.bin_upper_bound[np.isfinite(m.bin_upper_bound)]
    vals = np.concatenate([EDGES, b, np.nextafter(b, np.inf),
                           np.nextafter(b, -np.inf)])
    n_numeric = m.num_bin - (m.missing_type == 2)
    bounds = m.bin_upper_bound[:n_numeric]
    got = native.values_to_bins(vals, bounds, m.missing_type, m.num_bin - 1)
    assert _same(got, native.values_to_bins_plain(vals, bounds,
                                                  m.missing_type,
                                                  m.num_bin - 1))
    assert _same(got, ref_native.values_to_bins(vals, bounds,
                                                m.missing_type,
                                                m.num_bin - 1))
    # the mappers route through the libraries: the same codes
    assert _same(m.values_to_bins(vals), r.values_to_bins(vals))
    assert _same(m.values_to_bins(vals), got.astype(np.int32))


@pytest.mark.parametrize("missing", ["none", "zero", "nan"])
def test_values_to_bins_long_column_against_plain(missing):
    """A column long enough to spread over the library's threads: every
    code that of its plain version and of the same value searched
    alone in a short call."""
    m = _mapper(BinMapper, missing, 255)
    n_numeric = m.num_bin - (m.missing_type == 2)
    bounds = m.bin_upper_bound[:n_numeric]
    b = bounds[np.isfinite(bounds)]
    short = np.concatenate([EDGES, b, np.nextafter(b, np.inf),
                            np.nextafter(b, -np.inf)])
    rng = np.random.RandomState(7)
    vals = np.concatenate([np.tile(short, 400), rng.randn(100_003)])
    got = native.values_to_bins(vals, bounds, m.missing_type, m.num_bin - 1)
    assert len(vals) > 65536
    assert _same(got, native.values_to_bins_plain(vals, bounds,
                                                  m.missing_type,
                                                  m.num_bin - 1))
    alone = native.values_to_bins(short, bounds, m.missing_type,
                                  m.num_bin - 1)
    assert _same(got[:len(short) * 400], np.tile(alone, 400))


def test_library_and_numpy_search_differ_only_at_minus_1e35():
    """Where the library's search and the numpy mapper (the mappers'
    route for fewer than two numerical bins) disagree on the edge
    values: with zero as missing, -1e-35 lies on the zero bin's lower
    bound, so the search puts it in the bin below and numpy's
    |v| <= 1e-35 test in the zero bin.  The port follows the library,
    as the JAX package does with its library built (ROADMAP Queue 3, not
    a port fault)."""
    for missing in ("none", "zero", "nan"):
        m = _mapper(BinMapper, missing, 255)
        lib = m.values_to_bins(EDGES)
        differ = EDGES[lib != _numpy_route(m, EDGES)]
        assert differ.tolist() == ([-1e-35] if missing == "zero" else [])


def _numpy_route(m, vals):
    """BinMapper.values_to_bins's numpy branch for mapper `m`."""
    from lightgbm_tpu_torch.utils.binning import (K_ZERO_THRESHOLD,
                                                   MISSING_TYPE_NAN,
                                                   MISSING_TYPE_ZERO)
    n_numeric = m.num_bin - (1 if m.missing_type == MISSING_TYPE_NAN else 0)
    nan_mask = np.isnan(vals)
    v = np.where(nan_mask, 0.0, vals)
    ub = m.bin_upper_bound
    idx = np.searchsorted(ub[:n_numeric - 1], v, side="left")
    gt = (idx < n_numeric - 1) & (v > ub[np.minimum(idx, n_numeric - 2)])
    idx = np.clip(idx + gt, 0, n_numeric - 1).astype(np.int32)
    if m.missing_type == MISSING_TYPE_NAN:
        return np.where(nan_mask, m.num_bin - 1, idx)
    if m.missing_type == MISSING_TYPE_ZERO:
        return np.where(nan_mask | (np.abs(vals) <= K_ZERO_THRESHOLD),
                        m.default_bin, idx)
    return np.where(nan_mask, m.default_bin, idx)


def test_in_memory_bins_are_the_references():
    """The train path's bin codes, now through the library: the
    reference's matrix on NaN, zero and wide columns."""
    rng = np.random.RandomState(5)
    X = np.round(rng.randn(3000, 5), 2)
    X[::7, 1] = np.nan
    X[::3, 2] = 0.0
    X[:, 3] = rng.randn(3000)
    for params in ({}, {"zero_as_missing": True}, {"max_bin": 600}):
        dp = lt.Dataset(X, params=params).construct()
        dj = lgb.Dataset(X, params=params).construct()
        assert _same(dp.bin_data, np.asarray(dj.bin_data))


# --------------------------------------------------------- the host walk
def _walk_numpy(bst, X, K):
    out = np.zeros((len(X), K))
    for i, t in enumerate(bst.trees):
        out[:, i % K] += t.predict(X)
    return out


def _golden_rows(seed, f, cat=None):
    rng = np.random.RandomState(seed)
    X = rng.randn(700, f) * 2
    X[rng.rand(700, f) < 0.08] = np.nan
    X[:10] = 0.0
    if cat is not None:
        X[:, cat] = rng.randint(-2, 12, 700)
        X[:20, cat] = [1e300, np.inf, -np.inf, -0.5, 2.7] * 4
    return X


@pytest.mark.parametrize("family,f,cat", [
    ("binary", 6, None), ("regression_l2", 6, None),
    ("multiclass", 5, None), ("categorical", 5, 0)])
@pytest.mark.parametrize("threads", [1, 4])
def test_predict_rows_on_golden_models(family, f, cat, threads):
    """NaN rows, categorical values out of range and in (-1, 0), the
    multiclass interleaving: the library's walk, its plain version, the
    numpy tree walk and the JAX package's walk, bit for bit, at 1 and 4
    threads."""
    path = str(DATA / f"golden_{family}.model.txt")
    bst, ref = lt.Booster(model_file=path), lgb.Booster(model_file=path)
    K = bst.num_tree_per_iteration
    X = _golden_rows(len(family), f, cat)
    flat = bst._flatten_for_native(bst.trees)
    got = native.predict_rows(flat, X, K, threads)
    assert _same(got, native.predict_rows_plain(flat, X, K))
    assert _same(got, _walk_numpy(bst, X, K))
    bst.params["num_threads"] = threads
    bst.config.num_threads = threads
    raw = bst.predict(X, raw_score=True)
    assert _same(raw, ref.predict(X, raw_score=True))
    assert _same(raw, got[:, 0] if K == 1 else got)


def test_predict_rows_empty_bitset_span_routes_right():
    """A categorical split whose bitset span is empty (the loader takes
    it, training never writes it) sends every row right, (-1, 0)
    included, in the library as in its plain version and the numpy
    walk."""
    path = str(DATA / "golden_categorical.model.txt")
    bst = lt.Booster(model_file=path)
    t = next(t for t in bst.trees if t.num_cat > 0)
    t.cat_boundaries = np.zeros_like(t.cat_boundaries)
    t.cat_threshold = np.zeros(0, dtype=t.cat_threshold.dtype)
    bst._model_changed()
    X = _golden_rows(3, 5, 0)[:64]
    X[:16, 0], X[16:32, 0], X[32:48, 0] = -0.5, 0.0, 5.0
    flat = bst._flatten_for_native(bst.trees)
    got = native.predict_rows(flat, X, 1)
    assert _same(got, native.predict_rows_plain(flat, X, 1))
    assert _same(got, _walk_numpy(bst, X, 1))
    assert _same(bst.predict(X, raw_score=True), got[:, 0])


def test_predict_rows_stumps_and_slices():
    """Single-leaf trees (no node range), depth-1 stumps, and an
    iteration slice, which flattens its own trees."""
    rng = np.random.RandomState(7)
    X = rng.randn(800, 4)
    y = X[:, 0] + 0.1 * rng.randn(800)
    base = {"objective": "regression", "verbosity": -1,
            "device_type": "cpu", "min_data_in_leaf": 5}
    const = lt.train(dict(base, min_gain_to_split=1e18),
                     lt.Dataset(X, label=y), 4)
    stump = lt.train(dict(base, num_leaves=2), lt.Dataset(X, label=y), 6)
    assert all(t.num_leaves == 1 for t in const.trees)
    for bst in (const, stump):
        flat = bst._flatten_for_native(bst.trees)
        got = native.predict_rows(flat, X, 1)
        assert _same(got, native.predict_rows_plain(flat, X, 1))
        assert _same(got, _walk_numpy(bst, X, 1))
    part = stump.predict(X[:100], raw_score=True, num_iteration=3)
    want = sum(t.predict(X[:100]) for t in stump.trees[:3])
    assert _same(part, want)


# ---------------------------------------------------------------- the build
def test_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    """A source that does not compile: `get_lib` raises with the
    compiler's output (after the serial retry), and nothing is loaded."""
    bad = tmp_path / "libnative.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(lt.LightGBMError, match="did not build") as e:
        native.get_lib()
    assert "error" in str(e.value) and "-fopenmp" in str(e.value)
    assert native._LIB is None
    with pytest.raises(lt.LightGBMError):
        native.parse_dense(str(DATA / "golden_binary.model.txt"))


def test_library_is_built_once_into_the_ignored_build_dir():
    info = native.lib_info()
    path = Path(info["path"])
    assert path.parent == ROOT / "lightgbm_tpu_torch" / "csrc" / "build"
    assert path == native.library_path(info["flags"])
    assert info["compiler"] and isinstance(info["openmp"], bool)
    # the build directory is in .gitignore
    assert "lightgbm_tpu_torch/csrc/build/" in \
        (ROOT / ".gitignore").read_text().splitlines()
