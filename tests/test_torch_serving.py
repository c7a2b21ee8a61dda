"""The port's ServingRuntime against the JAX package's compiled rung.

On the CPU the port's runtime runs the plain versions of its kernels
(`device="cpu"`); its raw scores must be byte-identical to the JAX
`ServingRuntime(compiled="on")` on every golden family, at every row
bucket and across chunking.  Converted scores go through the f32
links (sigmoid, softmax), which the port computes in XLA's CPU
arithmetic (`ops/xla_math.py`): they must be byte-identical too.
"""
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
import lightgbm_tpu_torch.serving.runtime as port_rt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu.serving import ServingRuntime as JaxRuntime  # noqa: E402

#: bound on |port - jax| for converted f32 outputs, in units in the last
#: place: none since the links are XLA's bits (ROADMAP Queue 3 F1; with
#: torch's sigmoid and softmax the golden families differed by 1 ulp)
CONVERTED_MAX_ULP = 0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's links run with one intra-op thread here, as in
    `tests/test_torch_objectives.py`: this CPU build of torch can round
    a worker thread's share of the first `exp` of a process far off
    (ROADMAP Queue 3 (f)).  The links these tests reach, sigmoid and
    softmax, have not shown it, but softmax runs on worker threads at
    these sizes, and one thread keeps the comparison clear of it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _golden(name):
    path = ROOT / "tests" / "data" / f"golden_{name}.model.txt"
    X, _ = make_case_data(GOLDEN_CASES[name])
    return (lgb.Booster(model_file=str(path)),
            lt.Booster(model_file=str(path)), X[:700])


def _ulp(a, b):
    assert a.dtype == b.dtype == np.float32
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    # same-sign outputs: the distance between bit patterns counts ulps
    assert np.all((ia < 0) == (ib < 0))
    return int(np.max(np.abs(ia - ib)))


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_raw_scores_byte_identical_to_jax_compiled_rung(name):
    bj, bp, X = _golden(name)
    jrt = JaxRuntime(bj, compiled="on")
    assert jrt.compiled_active
    want = jrt.predict(X, raw_score=True)
    rt = lt.ServingRuntime(bp, device="cpu")
    assert rt.compiled_active
    # rows are independent on both sides: the JAX answer for 700 rows
    # sliced is its answer for fewer (tests/test_serving_compiler.py)
    for n in (1, 255, 257, 700):
        got = rt.predict(X[:n], raw_score=True)
        assert got.dtype == want.dtype and got.shape == want[:n].shape
        assert np.array_equal(got.view(np.uint64), want[:n].view(np.uint64))
    # above max_batch_rows: chunks of 300, 300 and 100 rows; the 300-row
    # chunks pad to 512 for the 256-row blocks
    small = lt.ServingRuntime(bp, device="cpu", max_batch_rows=300)
    got = small.predict(X, raw_score=True)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    conv = rt.predict(X)
    conv_want = jrt.predict(X)
    assert conv.shape == conv_want.shape
    assert _ulp(conv, conv_want) <= CONVERTED_MAX_ULP
    # the port's converted scores are its own f64 sums through its link
    own = bp.objective_.convert_output(
        torch.from_numpy(got).to(torch.float32)).numpy()
    assert np.array_equal(conv, own)


def test_probe_raises_on_corrupted_plane(monkeypatch):
    # the doctored child word of tests/test_serving_compiler.py: the port
    # has no lower rung, so the parity probe refuses the model outright
    _, bp, _ = _golden("binary")
    orig = port_rt.build_plan

    def doctored(ex, **kw):
        plan = orig(ex, **kw)
        plan.planes[0]["kids"][0, 0, 0] = (3 << 16) | 3
        return plan

    monkeypatch.setattr(port_rt, "build_plan", doctored)
    with pytest.raises(lt.LightGBMError, match="parity probe"):
        lt.ServingRuntime(bp, device="cpu")


def test_models_outside_the_compiled_path_raise():
    """Models the compiled rung cannot serve used to raise here; the
    ladder now chooses a rung for them (tests/test_torch_serving_ladder.py
    holds each rung): a random forest is served on the slot path, byte-
    identical to `Booster.predict`, and an X narrower than the model is
    walked on the host, which answers (or raises) as `Booster.predict`
    does."""
    text = (ROOT / "tests" / "data" / "golden_binary.model.txt").read_text()
    rf = text.replace("objective=binary sigmoid:1\n",
                      "objective=binary sigmoid:1\naverage_output\n")
    bp = lt.Booster(model_str=rf)
    rt = lt.ServingRuntime(bp, device="cpu")
    assert rt.rung == "slot_path" and not rt.compiled_active
    X, _ = make_case_data(GOLDEN_CASES["binary"])
    for raw in (True, False):
        assert np.array_equal(rt.predict(X[:300], raw_score=raw),
                              bp.predict(X[:300], raw_score=raw))
    rt = lt.ServingRuntime(lt.Booster(model_str=text), device="cpu")
    with pytest.raises(IndexError):
        lt.Booster(model_str=text).predict(np.zeros((3, 2)))
    with pytest.raises(IndexError):
        rt.predict(np.zeros((3, 2)))


def test_warmup_and_empty_requests():
    bj, bp, X = _golden("multiclass")
    rt = lt.ServingRuntime(bp, device="cpu", max_batch_rows=8)
    assert rt.buckets() == [1, 2, 4, 8]
    assert rt.warmup() == 4
    assert rt.num_class == 3 and rt.num_feature() == X.shape[1]
    assert rt.predict(X[:0]).shape == (0, 3)
    for n in (1, 3, 8, 9):
        assert np.array_equal(rt.predict(X[:n], raw_score=True),
                              bp.predict(X[:n], raw_score=True))
