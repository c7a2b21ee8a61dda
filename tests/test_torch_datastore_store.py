"""External memory's store on the CPU, after the JAX package's
tests/test_datastore.py and against the live package: the manifest and
shard files are the reference's bytes, corruption and truncation raise
naming the file, `save_binary` is refused, a subset reads only its
shards, `append_rows` grows a store, `auto_shard_rows` is the
reference's, the assembly stays in its budget, a bundled set spills and
assembles its bundle payload, the two_round route from a file bins
straight into the store, and the port streams where the reference
streams (the shard-streamed grower: tests/test_torch_streaming.py).
Spilled models of the golden families: test_torch_datastore.py."""
import glob
import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu.datastore import ShardWriter as RefWriter  # noqa: E402
from lightgbm_tpu.datastore import auto_shard_rows as ref_auto  # noqa: E402
from lightgbm_tpu_torch.datastore import (ShardStore, ShardWriter,  # noqa
                                          auto_shard_rows)
from lightgbm_tpu_torch.resilience import FAULTS  # noqa: E402
from lightgbm_tpu_torch.telemetry import REGISTRY  # noqa: E402

CPU = {"device_type": "cpu", "verbosity": -1}
EXT = {"external_memory": True, "datastore_shard_rows": 256}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the links' bits (as in
    test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _case(name):
    case = GOLDEN_CASES[name]
    X, y = make_case_data(case)
    params = dict(case["params"], **CPU)
    if case.get("categorical"):
        params["categorical_feature"] = case["categorical"]
    return X, y, params, case["rounds"]


def _strip(text):
    """A model text less its `[param: value]` lines (the spill's settings
    are echoed there)."""
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("["))


def _three(params, X, y, rounds):
    """The port in memory, the port spilled, the reference spilled."""
    mem = lt.train(dict(params), lt.Dataset(X, label=y), rounds)
    ext = lt.train(dict(params, **EXT), lt.Dataset(X, label=y), rounds)
    ref = lgb.train(dict(params, **EXT), lgb.Dataset(X, label=y), rounds)
    return mem, ext, ref


def _spilled(module, tmp, X, y, **extra):
    ds = module.Dataset(X, label=y)
    ds.params = dict(CPU, **EXT, datastore_dir=str(tmp), **extra)
    return ds.construct()


def test_store_bytes_are_the_references(tmp_path):
    """The same manifest and shard files as the JAX package writes, and
    either package opens the other's store."""
    X, y, _, _ = _case("binary")
    dp = _spilled(lt, tmp_path / "port", X, y)
    dj = _spilled(lgb, tmp_path / "ref", X, y)
    pdir, jdir = dp.datastore.dirpath, dj.datastore.dirpath
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir))
    for name in names:
        assert Path(pdir, name).read_bytes() == Path(jdir, name).read_bytes()
    other = ShardStore.open(jdir)
    assert np.array_equal(other.read_all_rows("bins"),
                          dp.datastore.read_all_rows("bins"))
    assert np.array_equal(other.load_vector("label"), y.astype(np.float32))


def test_manifest_tamper_and_truncation_raise(tmp_path):
    X, y, _, _ = _case("binary")
    d = _spilled(lt, tmp_path, X, y).datastore.dirpath
    shard = os.path.join(d, "shard-00001.bins")
    with open(shard, "r+b") as fh:
        fh.truncate(100)
    store = ShardStore.open(d)
    with pytest.raises(lt.LightGBMError, match="truncated.*shard-00001"):
        store.load_shard(1)
    mpath = os.path.join(d, "manifest.json")
    m = json.load(open(mpath))
    m["n_rows"] += 1
    json.dump(m, open(mpath, "w"))
    with pytest.raises(lt.LightGBMError, match="checksum mismatch"):
        ShardStore.open(d)
    open(mpath, "w").write("{")
    with pytest.raises(lt.LightGBMError, match="bad JSON"):
        ShardStore.open(d)


def test_shard_corruption_fails_training_naming_the_file(tmp_path):
    X, y, params, _ = _case("binary")
    ds = lt.Dataset(X, label=y)
    ds.params = dict(params, **EXT, datastore_dir=str(tmp_path))
    ds.construct()
    shard = sorted(glob.glob(os.path.join(ds.datastore.dirpath,
                                          "shard-*.bins")))[2]
    buf = bytearray(open(shard, "rb").read())
    buf[17] ^= 0xFF
    open(shard, "wb").write(bytes(buf))
    with pytest.raises(lt.LightGBMError,
                       match=f"checksum mismatch: {shard}"):
        lt.train(dict(params, **EXT), ds, 2)


def test_prefetch_fault_raises():
    X, y, params, _ = _case("binary")
    FAULTS.arm("prefetch.read:error@after=2")
    try:
        with pytest.raises(lt.LightGBMError, match="prefetch failed"):
            lt.train(dict(params, **EXT), lt.Dataset(X, label=y), 1)
    finally:
        FAULTS.disarm()


def test_save_binary_refused_when_spilled(tmp_path):
    X, y, _, _ = _case("binary")
    ds = _spilled(lt, tmp_path, X, y)
    with pytest.raises(lt.LightGBMError, match="external-memory"):
        ds.save_binary(str(tmp_path / "x.bin"))


def test_subset_reads_only_its_shards(tmp_path):
    """Rows 0-399 lie in shards 0 and 1 of 8: the other bytes are never
    read and count as saved; the rows, labels and a model trained on the
    subset are the reference's."""
    X, y, params, _ = _case("binary")
    ds = _spilled(lt, tmp_path / "p", X, y, enable_bundle=False)
    dj = _spilled(lgb, tmp_path / "j", X, y, enable_bundle=False)
    before = REGISTRY.counter("datastore.h2d_bytes_saved").value
    sub = ds.subset(np.arange(400)).construct()
    saved = REGISTRY.counter("datastore.h2d_bytes_saved").value - before
    assert saved == (len(X) - 400) * X.shape[1]
    assert np.array_equal(sub.bin_data,
                          ds.datastore.read_all_rows("bins")[:400])
    assert np.array_equal(sub.get_label(), y[:400].astype(np.float32))
    rows = np.sort(np.random.RandomState(1).choice(len(X), 300, False))
    got = ds.datastore.gather_rows(rows)
    want = dj.datastore.gather_rows(rows)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    p = dict(params, enable_bundle=False)
    assert lt.train(p, ds.subset(rows), 3).model_to_string() == \
        lgb.train(p, dj.subset(rows), 3).model_to_string()


def test_append_rows_grows_a_store(tmp_path):
    X, y, _, _ = _case("binary")
    bins = lt.Dataset(X, label=y).construct().bin_data
    stores = []
    for i, cls in enumerate((ShardWriter, RefWriter)):
        w = cls(str(tmp_path / str(i)), n_features=bins.shape[1],
                dtype=bins.dtype, shard_rows=300, has_label=True)
        w.append(bins[:700], label=y[:700])
        store = w.finalize()
        assert store.append_rows(bins[700:], label=y[700:]) == 1
        stores.append(store)
    port, ref = stores
    assert port.n_rows == len(X) and port.n_shards == ref.n_shards
    assert np.array_equal(port.read_all_rows(), bins)
    assert Path(port.dirpath, "manifest.json").read_bytes() == \
        Path(ref.dirpath, "manifest.json").read_bytes()
    with pytest.raises(lt.LightGBMError, match="misaligned"):
        port.append_rows(bins[:5])


@pytest.mark.parametrize("n", [1, 255, 10_000, 2_000_000])
@pytest.mark.parametrize("row_bytes", [1, 28, 60, 4096])
@pytest.mark.parametrize("budget", [0.01, 0.25, 64.0])
def test_auto_shard_rows_is_the_references(n, row_bytes, budget):
    for depth in (0, 1, 2, 5):
        assert auto_shard_rows(n, row_bytes, budget, depth) == \
            ref_auto(n, row_bytes, budget, depth)


def _over_budget():
    """20,000 x 13 bins (254 KiB) against a 0.1 MiB budget: the reference
    streams these."""
    rng = np.random.RandomState(9)
    X = rng.randn(20000, 13)
    y = (X[:, 0] - X[:, 3] + 0.1 * rng.randn(20000) > 0).astype(float)
    params = dict(CPU, objective="binary", num_leaves=7,
                  external_memory=True, datastore_budget_mb=0.1)
    return X, y, params


def test_streaming_choice_refuses_where_the_reference_streams():
    """streaming_train=on, and auto over the budget, stream where the
    reference streams, its streamed model byte for byte, and never
    assemble; off over the budget assembles (the reference's model), and
    auto where the reference downgrades (DART) assembles with its
    warning."""
    X, y, params = _over_budget()
    for extra in ({"streaming_train": "on"}, {}):
        ds = lt.Dataset(X, label=y)
        bst = lt.train(dict(params, **extra), ds, 2)
        assert bst._streaming is not None
        assert ds.bin_data is None and bst._dd._bins_fm is None
        assert _strip(bst.model_to_string()) == _strip(lgb.train(
            dict(params, **extra), lgb.Dataset(X, label=y),
            2).model_to_string())
    off = dict(params, streaming_train="off")
    assert lt.train(off, lt.Dataset(X, label=y), 3).model_to_string() == \
        lgb.train(off, lgb.Dataset(X, label=y), 3).model_to_string()
    dart = dict(params, boosting="dart")
    bst = lt.train(dart, lt.Dataset(X, label=y), 2)
    assert bst.model_to_string() == \
        lgb.train(dart, lgb.Dataset(X, label=y), 2).model_to_string()
    with pytest.raises(lt.LightGBMError, match="Unknown streaming_train"):
        lt.train(dict(params, streaming_train="bogus"),
                 lt.Dataset(X, label=y), 1)


def test_budget_bounds_the_assembly(tmp_path):
    """Assembled under the budget: the prefetch pipeline's residency
    within `datastore_budget_mb`, a `train.shard` span a shard, the
    prefetch counters a block each."""
    from lightgbm_tpu_torch.telemetry import TRACER, MemorySink
    X, y, params = _over_budget()
    sink = TRACER.add_sink(MemorySink())
    hits0 = REGISTRY.counter("datastore.prefetch.hit").value + \
        REGISTRY.counter("datastore.prefetch.stall").value
    try:
        bst = lt.train(dict(params, streaming_train="off"),
                       lt.Dataset(X, label=y), 2)
    finally:
        TRACER.remove_sink(sink)
    shards = bst.train_set.datastore.n_shards
    assert shards >= 4
    assert REGISTRY.gauge("datastore.peak_resident_mb").value <= 0.1
    spans = [e for e in sink.events if e.get("name") == "train.shard"]
    assert len(spans) == shards
    assert REGISTRY.counter("datastore.prefetch.hit").value + \
        REGISTRY.counter("datastore.prefetch.stall").value - hits0 == shards
    assert bst._dd.pf_stats.passes == 1


def test_sparse_input_stays_in_memory_with_the_references_warning():
    import scipy.sparse as sps
    rng = np.random.RandomState(2)
    m = sps.random(800, 20, density=0.1, random_state=rng, format="csr")
    y = (np.asarray(m.sum(axis=1)).ravel() > 0.5).astype(float)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ds = lt.Dataset(m, label=y, params=dict(CPU, **EXT)).construct()
    assert ds.datastore is None
    p = dict(CPU, objective="binary", num_leaves=7, **EXT)
    assert lt.train(p, lt.Dataset(m, label=y), 3).model_to_string() == \
        lgb.train(p, lgb.Dataset(m, label=y), 3).model_to_string()


def test_bundled_set_spills_and_assembles_both_matrices():
    """A one-hot block that EFB bundles: the store holds the bins and the
    bundle payload, both assembled; the reference's model."""
    rng = np.random.RandomState(4)
    n = 1500
    hot = np.zeros((n, 6))
    hot[np.arange(n), rng.randint(0, 6, n)] = rng.randint(1, 4, n)
    X = np.column_stack([rng.randn(n, 3), hot])
    y = X[:, 0] + hot[:, 2] - 0.5 * hot[:, 4] + 0.2 * rng.randn(n)
    params = dict(CPU, objective="regression", num_leaves=7)
    mem, ext, ref = _three(params, X, y, 4)
    store = ext.train_set.datastore
    assert ext.train_set.efb is not None and "bundle" in store.payloads
    assert ext._dd.bundle_fm.shape == (store.bundle_cols, n)
    assert ext.model_to_string() == ref.model_to_string()
    assert _strip(ext.model_to_string()) == _strip(mem.model_to_string())


def test_two_round_file_straight_into_the_store(tmp_path):
    """A CSV through two_round with external memory: no bin matrix on
    the host, the store's shards, the reference's model and the
    in-memory two_round model."""
    rng = np.random.RandomState(3)
    X = rng.randn(3000, 6)
    y = (X[:, 0] > 0).astype(np.float64)
    path = str(tmp_path / "train.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    params = dict(CPU, objective="binary", num_leaves=15, two_round=True)
    ext = dict(params, **EXT, datastore_dir=str(tmp_path / "store"))
    ds = lt.Dataset(path)
    ds.params = dict(ext)
    ds.construct()
    assert ds.bin_data is None and ds.datastore.n_shards > 1
    assert ds.datastore.n_rows == 3000
    m_ext = lt.train(ext, lt.Dataset(path), 5).model_to_string()
    assert m_ext == lgb.train(ext, lgb.Dataset(path), 5).model_to_string()
    m_mem = lt.train(dict(params, enable_bundle=False), lt.Dataset(path),
                     5).model_to_string()
    assert _strip(m_ext) == _strip(m_mem)
