"""Shard-streamed training (`lightgbm_tpu_torch/streaming/`) on the CPU,
after the JAX package's tests/test_streaming.py and against the live
package: every golden family trained with `streaming_train="on"` on a
fine shard grid (every tree takes many multi-shard passes) is the port's
in-memory model and the reference's streamed model, byte for byte less
the `[param: value]` lines, and the bins never assemble.  The options,
the budget, continuation, faults and downgrades:
test_torch_streaming_modes.py."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu_torch.streaming import engine  # noqa: E402

CPU = {"device_type": "cpu", "verbosity": -1}
#: the reference's grid (tests/test_streaming.py STREAM)
STREAM = {"external_memory": True, "streaming_train": "on",
          "datastore_shard_rows": 300}


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


def strip(text):
    """A model text less its `[param: value]` lines (the streaming
    settings and the port's device_type are echoed there)."""
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("["))


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_golden_family_streamed_is_in_memory_and_reference(name):
    case = GOLDEN_CASES[name]
    X, y = make_case_data(case)
    params = dict(case["params"], **CPU)
    if case.get("categorical"):
        params["categorical_feature"] = case["categorical"]
    rounds = case["rounds"]
    mem = lt.train(dict(params), lt.Dataset(X, label=y), rounds)
    sweeps = sum(engine.SWEEPS.values())
    ds = lt.Dataset(X, label=y)
    st = lt.train(dict(params, **STREAM), ds, rounds)
    assert st._streaming is not None
    assert sum(engine.SWEEPS.values()) > sweeps
    assert ds.bin_data is None and st._dd._bins_fm is None
    ref = lgb.train(dict(params, **STREAM), lgb.Dataset(X, label=y), rounds)
    assert strip(st.model_to_string()) == strip(mem.model_to_string())
    assert strip(st.model_to_string()) == strip(ref.model_to_string())
    assert torch.equal(torch.as_tensor(st.predict(X)),
                       torch.as_tensor(mem.predict(X)))
