"""External memory (`lightgbm_tpu_torch/datastore/`) on the CPU, after
the JAX package's tests/test_datastore.py and against the live package:
spilling the bins to shards and assembling them on the training device
leaves the model the in-memory one, byte for byte, and the reference's
spilled one, on the golden families, with bagging, DART and the wave
grower, at any prefetch depth, and in continued training.  The store
itself, EFB's bundle payload, the two_round route from a file,
corruption and the streaming choice: test_torch_datastore_store.py."""
import sys
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


def _strip(text):
    """A model text less its `[param: value]` lines (the spill's settings
    are echoed there)."""
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("["))


def _case(name):
    case = GOLDEN_CASES[name]
    X, y = make_case_data(case)
    params = dict(case["params"], **CPU)
    if case.get("categorical"):
        params["categorical_feature"] = case["categorical"]
    return X, y, params, case["rounds"]


def _three(params, X, y, rounds, **kw):
    """The port in memory, the port spilled, the reference spilled."""
    mem = lt.train(dict(params), lt.Dataset(X, label=y), rounds, **kw)
    ext = lt.train(dict(params, **EXT), lt.Dataset(X, label=y), rounds, **kw)
    ref = lgb.train(dict(params, **EXT), lgb.Dataset(X, label=y), rounds,
                    **kw)
    return mem, ext, ref


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_golden_family_spilled_is_in_memory_and_reference(name):
    X, y, params, rounds = _case(name)
    mem, ext, ref = _three(params, X, y, rounds)
    assert ext.train_set.datastore.n_shards == -(-len(X) // 256)
    assert ext.train_set.bin_data is None
    assert ext.model_to_string() == ref.model_to_string()
    assert _strip(ext.model_to_string()) == _strip(mem.model_to_string())
    assert np.array_equal(ext.predict(X), mem.predict(X))


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.7, "bagging_freq": 1, "bagging_seed": 7},
    {"boosting": "dart", "drop_rate": 0.3},
    {"tree_grow_policy": "wave"}], ids=["bagging", "dart", "wave"])
def test_sampled_and_replayed_runs(extra):
    """Bagging's masks, DART's drop replays (which read the assembled
    bins), the wave grower: spilled byte for byte in memory and the
    reference's."""
    X, y, params, _ = _case("binary")
    mem, ext, ref = _three(dict(params, **extra), X, y, 6)
    assert ext.model_to_string() == ref.model_to_string()
    assert _strip(ext.model_to_string()) == _strip(mem.model_to_string())


def test_prefetch_depth_does_not_change_the_model():
    X, y, params, _ = _case("regression_l2")
    texts = [lt.train(dict(params, **EXT, datastore_prefetch=d),
                      lt.Dataset(X, label=y), 5).model_to_string()
             for d in (1, 4)]
    assert _strip(texts[0]) == _strip(texts[1])


def test_init_model_continuation():
    X, y, params, _ = _case("binary")

    def two_stage(m, extra):
        p = dict(params, **extra)
        first = m.train(p, m.Dataset(X, label=y), 4)
        return m.train(p, m.Dataset(X, label=y), 4,
                       init_model=first).model_to_string()

    ext = two_stage(lt, EXT)
    assert ext == two_stage(lgb, EXT)
    assert _strip(ext) == _strip(two_stage(lt, {}))
