"""Shard-streamed training's options and edges on the CPU, after the JAX
package's tests/test_streaming.py: the prefetch depth does not change the
model; `streaming_train="auto"` streams once the spilled bins exceed
`datastore_budget_mb`, within the budget; continued training streams;
a prefetch fault mid-wave raises from `train` and leaves no reader
thread; each mode that cannot stream warns as the reference does and
trains in memory; the wave policy (fused: K3's candidates over the
carried histograms) and quantized gradients (the int32 carry, and the
packed carry against the reference's) stream byte for byte."""
import json
import logging
import sys
import threading
import time
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
from lightgbm_tpu_torch.resilience import FAULTS  # noqa: E402
from lightgbm_tpu_torch.streaming import engine  # noqa: E402
from lightgbm_tpu_torch.telemetry import REGISTRY  # noqa: E402

CPU = {"device_type": "cpu", "verbosity": -1}
STREAM = {"external_memory": True, "streaming_train": "on",
          "datastore_shard_rows": 300}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    FAULTS.disarm()
    try:
        yield
    finally:
        FAULTS.disarm()
        torch.set_num_threads(n)


def strip(text):
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("["))


def _binary():
    case = GOLDEN_CASES["binary"]
    X, y = make_case_data(case)
    return X, y, dict(case["params"], **CPU)


def _pair(params, X, y, rounds, **kw):
    mem = lt.train(dict(params), lt.Dataset(X, label=y), rounds, **kw)
    st = lt.train(dict(params, **STREAM), lt.Dataset(X, label=y), rounds,
                  **kw)
    assert st._streaming is not None
    return mem, st


@pytest.mark.parametrize("depth", [1, 4])
def test_prefetch_depth_does_not_change_the_model(depth):
    X, y, params = _binary()
    mem, st = _pair(dict(params, streaming_prefetch_depth=depth), X, y, 4)
    assert st._streaming.depth == depth
    assert strip(st.model_to_string()) == strip(mem.model_to_string())


def test_auto_streams_over_the_budget_within_it():
    """The bins (20000 x 13 u8, 0.25 MB) exceed a 0.1 MB budget: "auto"
    streams, each pass's staging (the shard folded and the one before)
    stays within the budget, and no audit counts a violation."""
    rng = np.random.RandomState(9)
    X = rng.randn(20000, 13)
    y = (X[:, 0] - X[:, 3] + 0.1 * rng.randn(20000) > 0).astype(float)
    params = dict(CPU, objective="binary", num_leaves=7)
    viol = REGISTRY.counter("mem.budget_violation",
                            contract="datastore_budget_mb").value
    ds = lt.Dataset(X, label=y)
    st = lt.train(dict(params, external_memory=True,
                       datastore_budget_mb=0.1), ds, 2)
    assert st._streaming is not None and ds.datastore.n_shards >= 4
    assert ds.datastore.total_bytes("bins") > 0.1 * 2 ** 20
    assert 0 < REGISTRY.gauge("stream.peak_staging_mb").value <= 0.1
    assert REGISTRY.counter("mem.budget_violation",
                            contract="datastore_budget_mb").value == viol
    mem = lt.train(params, lt.Dataset(X, label=y), 2)
    assert strip(st.model_to_string()) == strip(mem.model_to_string())


def test_init_model_continuation():
    X, y, params = _binary()
    base = lt.train(dict(params), lt.Dataset(X, label=y), 3)
    mem, st = _pair(params, X, y, 2, init_model=base)
    assert st.current_iteration() == 5
    assert strip(st.model_to_string()) == strip(mem.model_to_string())


def test_prefetch_fault_mid_wave_raises_and_stops_the_reader():
    """The fault hits the first partition pass, after the root pass has
    read every shard."""
    X, y, params = _binary()
    ds = lt.Dataset(X, label=y)
    ds.params = dict(STREAM)
    shards = ds.construct().datastore.n_shards
    passes = engine.SWEEPS["partition"]
    FAULTS.arm(f"prefetch.read:error@after={shards + 2}")
    with pytest.raises(lt.LightGBMError, match="injected fault"):
        lt.train(dict(params, **STREAM), ds, 2)
    FAULTS.disarm()
    assert engine.SWEEPS["partition"] == passes + 1
    deadline = time.monotonic() + 10.0
    while any(t.name == "lgbt-datastore-prefetch" and t.is_alive()
              for t in threading.enumerate()):
        assert time.monotonic() < deadline, "the prefetch reader leaked"
        time.sleep(0.01)


def _downgrade_case(name, tmp_path):
    X, y, params = _binary()
    if name == "efb":
        # one-hot columns that EFB bundles
        rng = np.random.RandomState(3)
        hot = np.eye(4)[rng.randint(0, 4, len(X))]
        X = np.hstack([X, hot])
        return X, y, params, "EFB bundling"
    if name == "forced":
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({"feature": 1, "threshold": 0.0}))
        return X, y, dict(params, forcedsplits_filename=str(path)), \
            "forced splits"
    extra, why = {
        "intermediate": ({"monotone_constraints": [0, 1, 0, 0, 0, 0],
                          "monotone_constraints_method": "intermediate"},
                         "monotone_constraints_method=intermediate"),
        "pool": ({"histogram_pool_size": 0.001},
                 "bounded histogram pool"),
        "dart": ({"boosting": "dart"}, "boosting=dart"),
        "linear": ({"linear_tree": True}, "linear_tree")}[name]
    return X, y, dict(params, **extra), why


@pytest.mark.parametrize("name", ["efb", "forced", "intermediate", "pool",
                                  "dart", "linear"])
def test_modes_that_cannot_stream_warn_and_train_in_memory(name, tmp_path,
                                                           caplog):
    X, y, params, why = _downgrade_case(name, tmp_path)
    params["verbosity"] = 0
    caplog.set_level(logging.WARNING)
    st = lt.train(dict(params, **STREAM), lt.Dataset(X, label=y), 2)
    assert st._streaming is None
    assert "streaming_train=on is not supported with" in caplog.text
    assert why in caplog.text
    off = lt.train(dict(params, streaming_train="off"),
                   lt.Dataset(X, label=y), 2)
    assert strip(st.model_to_string()) == strip(off.model_to_string())


@pytest.mark.parametrize("extra", [
    {"tree_grow_policy": "wave"},
    {"tree_grow_policy": "wave", "tpu_wave_width": 3,
     "tpu_wave_strict_tail": 4, "tpu_fused_split": False},
    {"use_quantized_grad": True},
    {"use_quantized_grad": True, "tree_grow_policy": "wave"},
    {"bagging_fraction": 0.7, "bagging_freq": 1, "feature_fraction": 0.8,
     "tree_grow_policy": "wave", "tpu_wave_overgrow": 1.5},
], ids=["wave_fused", "wave_unfused", "quant_strict", "quant_wave",
        "bagged_overgrown_wave"])
def test_policies_and_quantized_stream_byte_for_byte(extra):
    X, y, params = _binary()
    mem, st = _pair(dict(params, **extra), X, y, 4)
    assert st._grower_spec.hist_impl == ("kernel_q" if "use_quantized_grad"
                                         in extra else "kernel")
    assert strip(st.model_to_string()) == strip(mem.model_to_string())


def test_packed_quantized_regression_is_the_references():
    """hist_impl="packed" streams on the packed int32 carry; regression
    is the reference's streamed model bit for bit."""
    case = GOLDEN_CASES["regression_l2"]
    X, y = make_case_data(case)
    params = dict(case["params"], **CPU, use_quantized_grad=True,
                  hist_impl="packed", num_leaves=15)
    mem, st = _pair(params, X, y, 3)
    assert st._grower_spec.hist_impl == "packed"
    ref = lgb.train(dict(params, **STREAM), lgb.Dataset(X, label=y), 3)
    assert strip(st.model_to_string()) == strip(mem.model_to_string())
    assert strip(st.model_to_string()) == strip(ref.model_to_string())
