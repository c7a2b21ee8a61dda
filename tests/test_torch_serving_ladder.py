"""The port's serving ladder: rungs chosen by the model and the options,
each exact rung byte-identical to the JAX package's same rung, and no
fallback.

* Each rung pinned by options (`compiled`, `device_sum`, `slot_path`,
  and `host_walk` for a linear-tree model) equals the JAX
  `ServingRuntime` on the same rung, raw and converted, on every golden
  family.
* The selection table: linear trees, a random forest, a model the plan
  refuses, the options, a narrow X.
* The refresh probes raise on doctored planes.
* A fault at a rung raises (`ServingDeviceError`), is counted, opens only
  that rung's breaker and no other rung answers (the JAX package's
  ladder falls through instead: ROADMAP Queue 3 (s)); after disarm and
  the backoff the background re-probe closes the breaker and the bytes
  are those before the fault.  A content mismatch at the re-probe is
  permanent until `refresh()`.  A hang is bounded by the watchdog.
* `demote`, `stale`, `device_bytes`, `warmup`.
"""
import sys
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
import lightgbm_tpu_torch.serving.runtime as port_rt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu.serving import ServingRuntime as JaxRuntime  # noqa: E402
from lightgbm_tpu_torch import telemetry  # noqa: E402
from lightgbm_tpu_torch.resilience import (  # noqa: E402
    CLOSED, FAULTS, OPEN, PERMANENT, DeviceTimeoutError)
from lightgbm_tpu_torch.serving import (  # noqa: E402
    ServingDeviceError, ServingUnavailableError)

#: options pinning each exact device rung, on both packages
PINS = {
    "compiled": ({}, {"compiled": "on"}),
    "device_sum": ({"compiled": "off"}, {}),
    "slot_path": ({"compiled": "off", "device_sum": "off"},
                  {"device_sum": "off"}),
}


@pytest.fixture(autouse=True)
def clean_faults_and_one_thread():
    """The fault plane is process-global: nothing leaks between tests.
    One intra-op thread for the links, as in test_torch_serving.py."""
    FAULTS.disarm()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        FAULTS.disarm()
        torch.set_num_threads(n)


def _golden(name):
    path = ROOT / "tests" / "data" / f"golden_{name}.model.txt"
    X, _ = make_case_data(GOLDEN_CASES[name])
    return (lgb.Booster(model_file=str(path)),
            lt.Booster(model_file=str(path)), X[:600])


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view({8: np.uint64, 4: np.uint32}[a.dtype.itemsize]),
        b.view({8: np.uint64, 4: np.uint32}[b.dtype.itemsize]))


def _cval(name, **labels):
    return telemetry.REGISTRY.counter(name, **labels).value


# ------------------------------------------------- each rung, pinned
@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
@pytest.mark.parametrize("rung", sorted(PINS))
def test_pinned_rung_byte_identical_to_reference(name, rung):
    bj, bp, X = _golden(name)
    ours, theirs = PINS[rung]
    jrt = JaxRuntime(bj, **theirs)
    # the JAX runtime answers from its highest live rung
    assert jrt.compiled_active == (rung == "compiled")
    assert jrt.device_sum_active == (rung != "slot_path")
    rt = lt.ServingRuntime(bp, device="cpu", **ours)
    assert rt.rung == rung
    served = _cval(f"serve.{rung}")
    clock = telemetry.StageClock()
    for raw in (True, False):
        got = rt.predict(X, raw_score=raw, clock=clock)
        assert _bits(got, jrt.predict(X, raw_score=raw))
        assert _bits(got, bp.predict(X, raw_score=raw))
    assert clock.rung == rung and _cval(f"serve.{rung}") == served + 2
    # rows are independent: a ragged slice is the whole answer's rows
    assert _bits(rt.predict(X[3:40], raw_score=True),
                 rt.predict(X, raw_score=True)[3:40])


def _linear_text():
    rng = np.random.RandomState(11)
    X = rng.randn(600, 4)
    y = 1.5 * X[:, 0] - X[:, 1] + 0.3 * X[:, 2] * (X[:, 3] > 0) \
        + 0.05 * rng.randn(600)
    bst = lgb.train({"objective": "regression", "linear_tree": True,
                     "num_leaves": 7, "verbosity": -1},
                    lgb.Dataset(X, label=y), num_boost_round=4)
    return bst.model_to_string(), X


def test_linear_trees_take_the_host_walk():
    text, X = _linear_text()
    bj, bp = lgb.Booster(model_str=text), lt.Booster(model_str=text)
    assert bp.trees[0].is_linear
    jrt = JaxRuntime(bj)
    rt = lt.ServingRuntime(bp, device="cpu")
    assert rt.rung == "host_walk" and rt.status()["cause"] == "linear_tree"
    walked = _cval("serve.host_walk", cause="linear_tree")
    for raw in (True, False):
        got = rt.predict(X[:200], raw_score=raw)
        assert _bits(got, jrt.predict(X[:200], raw_score=raw))
        assert _bits(got, bp.predict(X[:200], raw_score=raw))
    assert _cval("serve.host_walk", cause="linear_tree") == walked + 2
    assert rt.warmup() == 0 and rt.device_bytes() == 0


# ------------------------------------------------- the selection table
def _rf_text():
    text = (ROOT / "tests" / "data" / "golden_binary.model.txt").read_text()
    return text.replace("objective=binary sigmoid:1\n",
                        "objective=binary sigmoid:1\naverage_output\n")


def _plan_refused_text():
    text = (ROOT / "tests" / "data" / "golden_regression_l2.model.txt"
            ).read_text()
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("split_feature="))
    feats = lines[i].split("=", 1)[1].split()
    feats[0] = "4096"
    lines[i] = "split_feature=" + " ".join(feats)
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("case,opts,rung,cause", [
    ("plain", {}, "compiled", "plan"),
    ("plain", {"compiled": "off"}, "device_sum", "compiled_off"),
    ("plain", {"compiled": "off", "device_sum": "off"}, "slot_path",
     "device_sum_off"),
    ("plain", {"device_sum": "off"}, "compiled", "plan"),
    ("rf", {}, "slot_path", "random_forest"),
    ("rf", {"compiled": "off", "device_sum": "off"}, "slot_path",
     "random_forest"),
    ("refused", {}, "device_sum", "plan_refused"),
    ("refused", {"device_sum": "off"}, "slot_path", "device_sum_off"),
])
def test_selection_table(case, opts, rung, cause):
    text = {"plain": (ROOT / "tests" / "data" /
                      "golden_regression_l2.model.txt").read_text(),
            "rf": _rf_text(), "refused": _plan_refused_text()}[case]
    bj, bp = lgb.Booster(model_str=text), lt.Booster(model_str=text)
    sel = _cval("serve.rung_selected", rung=rung, cause=cause)
    rt = lt.ServingRuntime(bp, device="cpu", **opts)
    assert (rt.rung, rt.status()["cause"]) == (rung, cause)
    assert rt.status()["rung"] == rung
    assert _cval("serve.rung_selected", rung=rung, cause=cause) == sel + 1
    Xg, _ = make_case_data(GOLDEN_CASES["regression_l2"])
    X = np.zeros((300, 4097 if case == "refused" else 6))
    X[:, :6] = Xg[:300]
    X[:, -1] = np.random.RandomState(1).randn(300)
    for raw in (True, False):
        got = rt.predict(X, raw_score=raw)
        assert _bits(got, bp.predict(X, raw_score=raw))
        assert _bits(got, bj.predict(X, raw_score=raw))


def test_narrow_x_is_walked_on_the_host():
    bj, bp, X = _golden("binary")
    rt = lt.ServingRuntime(bp, device="cpu")
    used = sorted({int(f) for t in bp.trees
                   for f in t.split_feature[:t.num_leaves - 1]})
    narrow = X[:50, :used[-1]]     # one column short of the last split
    forced = _cval("serve.host_walk", cause="forced")
    clock = telemetry.StageClock()
    try:
        got = rt.predict(narrow, raw_score=True, clock=clock)
        want = bp.predict(narrow, raw_score=True)
        assert _bits(got, want)
    except IndexError:
        # the f64 walk indexes the missing column, as the JAX package's
        # host walk does for such rows
        with pytest.raises(IndexError):
            bp.predict(narrow, raw_score=True)
    assert clock.rung == "host_walk"
    assert _cval("serve.host_walk", cause="forced") == forced + 1
    empty = rt.predict(X[:0])
    assert empty.shape == (0,) and empty.dtype == np.float32


# ----------------------------------------------------------- probes
def test_device_sum_probe_raises_on_doctored_values(monkeypatch):
    _, bp, _ = _golden("binary")
    orig = bp.export_predict_arrays

    def doctored(*a, **kw):
        ex = dict(orig(*a, **kw))
        v = ex["value_f64"].clone()
        v[0, 0] += 1e-9
        ex["value_f64"] = v
        return ex

    monkeypatch.setattr(bp, "export_predict_arrays", doctored)
    with pytest.raises(lt.LightGBMError, match="device_sum parity probe"):
        lt.ServingRuntime(bp, device="cpu", compiled="off")


def test_slot_path_probe_raises_on_wrong_slots(monkeypatch):
    _, bp, _ = _golden("binary")
    orig = port_rt.predict_leaf_ensemble

    def wrong(stacked, X):
        out = orig(stacked, X).clone()
        out[3, ::5] ^= 1
        return out

    monkeypatch.setattr(port_rt, "predict_leaf_ensemble", wrong)
    with pytest.raises(lt.LightGBMError, match="slot_path parity probe"):
        lt.ServingRuntime(bp, device="cpu", compiled="off",
                          device_sum="off")


def test_compiled_probe_raises_on_doctored_plane(monkeypatch):
    _, bp, _ = _golden("multiclass")
    orig = port_rt.build_plan

    def doctored(ex, **kw):
        plan = orig(ex, **kw)
        plan.planes[0]["kids"][0, 0, 0] = (3 << 16) | 3
        return plan

    monkeypatch.setattr(port_rt, "build_plan", doctored)
    with pytest.raises(lt.LightGBMError, match="compiled parity probe"):
        lt.ServingRuntime(bp, device="cpu")


# ----------------------------------------------------------- faults
RUNG_OPTS = {"compiled": {}, "device_sum": {"compiled": "off"},
             "slot_path": {"compiled": "off", "device_sum": "off"},
             "bounded": {"precision": "bounded"}}


@pytest.mark.parametrize("rung", sorted(RUNG_OPTS))
def test_fault_raises_opens_only_its_breaker_then_recovers(rung):
    _, bp, X = _golden("multiclass")
    rt = lt.ServingRuntime(bp, device="cpu", breaker_backoff_s=30.0,
                           **RUNG_OPTS[rung])
    assert rt.rung == rung
    before = rt.predict(X, raw_score=True)
    served = {r: _cval(f"serve.{r}") for r in port_rt.DEVICE_RUNGS}
    walked = sum(c.value for c in
                 telemetry.REGISTRY.counter_family("serve.host_walk"))
    errors = _cval("serve.device_errors", rung=rung)
    FAULTS.arm(f"serve.dispatch.{rung}:error")
    with pytest.raises(ServingDeviceError, match=rung):
        rt.predict(X, raw_score=True)
    assert _cval("serve.device_errors", rung=rung) == errors + 1
    states = rt.breaker_states()
    assert states.pop(rung) == OPEN
    assert set(states.values()) == {CLOSED}
    # while it is open, requests fail fast: no other rung answers
    FAULTS.disarm()
    with pytest.raises(ServingUnavailableError):
        rt.predict(X, raw_score=True)
    assert {r: _cval(f"serve.{r}") for r in port_rt.DEVICE_RUNGS} == served
    assert sum(c.value for c in telemetry.REGISTRY.counter_family(
        "serve.host_walk")) == walked
    assert rt.status()["breakers"][rung] == OPEN
    # the backoff elapses (an injected clock): the next request starts
    # the re-probe and still fails fast; the re-probe closes the breaker
    now = time.monotonic() + 31.0
    rt._breakers[rung]._clock = lambda: now
    recovered = _cval("serve.breaker.recovered", rung=rung)
    with pytest.raises(ServingUnavailableError):
        rt.predict(X, raw_score=True)
    rt.join_reprobes(timeout=60)
    assert rt.breaker_states()[rung] == CLOSED
    assert _cval("serve.breaker.recovered", rung=rung) == recovered + 1
    assert _bits(rt.predict(X, raw_score=True), before)


def test_reprobe_failure_doubles_backoff_and_mismatch_is_permanent():
    _, bp, X = _golden("binary")
    rt = lt.ServingRuntime(bp, device="cpu", breaker_backoff_s=10.0,
                           breaker_backoff_max_s=100.0)
    before = rt.predict(X, raw_score=True)
    now = [time.monotonic()]
    br = rt._breakers["compiled"]
    br._clock = lambda: now[0]
    FAULTS.arm("serve.dispatch.compiled:error")
    with pytest.raises(ServingDeviceError):
        rt.predict(X[:5])
    # the fault is still armed: the re-probe errors, the backoff doubles
    now[0] += 10.0
    with pytest.raises(ServingUnavailableError):
        rt.predict(X[:5])
    rt.join_reprobes(timeout=60)
    assert br.state == OPEN
    now[0] += 15.0                      # < 20: the doubled backoff holds
    with pytest.raises(ServingUnavailableError):
        rt.predict(X[:5])
    assert br.state == OPEN
    # wrong content at the re-probe: permanent, whatever the clock says
    FAULTS.disarm()
    FAULTS.arm("serve.d2h.compiled:corrupt")
    now[0] += 10.0
    with pytest.raises(ServingUnavailableError):
        rt.predict(X[:5])
    rt.join_reprobes(timeout=60)
    assert br.state == PERMANENT
    FAULTS.disarm()
    now[0] += 1e6
    with pytest.raises(ServingUnavailableError):
        rt.predict(X[:5])
    assert br.state == PERMANENT
    rt.refresh()                        # the way out: a fresh export
    assert br.state == CLOSED
    assert _bits(rt.predict(X, raw_score=True), before)


@pytest.mark.parametrize("verdict", ["permanent", "open"])
def test_failed_refresh_keeps_the_breakers_verdict(verdict):
    # a refresh whose probe fails publishes nothing, and the breakers
    # keep their states: a permanent verdict on the old bytes stands,
    # an open breaker keeps its backoff; a refresh that passes resets
    _, bp, X = _golden("binary")
    rt = lt.ServingRuntime(bp, device="cpu", breaker_backoff_s=10.0)
    before = rt.predict(X, raw_score=True)
    now = [time.monotonic()]
    br = rt._breakers["compiled"]
    br._clock = lambda: now[0]
    FAULTS.arm("serve.dispatch.compiled:error")
    with pytest.raises(ServingDeviceError):
        rt.predict(X[:5])
    FAULTS.disarm()
    if verdict == "permanent":
        FAULTS.arm("serve.d2h.compiled:corrupt")
        now[0] += 10.0
        with pytest.raises(ServingUnavailableError):
            rt.predict(X[:5])
        rt.join_reprobes(timeout=60)
        FAULTS.disarm()
    want = {"permanent": PERMANENT, "open": OPEN}[verdict]
    assert br.state == want
    state = rt._state
    FAULTS.arm("serve.dispatch.compiled:error")
    with pytest.raises(lt.LightGBMError, match="compiled parity probe"):
        rt.refresh()
    FAULTS.disarm()
    assert rt._state is state and br.state == want
    with pytest.raises(ServingUnavailableError):
        rt.predict(X[:5])
    assert br.state == want
    rt.refresh()
    assert br.state == CLOSED
    assert _bits(rt.predict(X, raw_score=True), before)


def test_hang_is_bounded_by_the_watchdog():
    _, bp, X = _golden("binary")
    rt = lt.ServingRuntime(bp, device="cpu", dispatch_timeout_ms=100.0,
                           compiled="off")
    fired = _cval("serve.watchdog.fired", site="serve.dispatch.device_sum")
    FAULTS.arm("serve.dispatch.device_sum:hang")
    with pytest.raises(ServingDeviceError) as e:
        rt.predict(X[:8])
    assert isinstance(e.value.__cause__, DeviceTimeoutError)
    assert _cval("serve.watchdog.fired",
                 site="serve.dispatch.device_sum") == fired + 1
    assert rt.breaker_states()["device_sum"] == OPEN
    FAULTS.disarm()                     # frees the parked worker


def test_fault_before_construction_fails_the_refresh():
    _, bp, _ = _golden("binary")
    FAULTS.arm("serve.dispatch.compiled:error")
    with pytest.raises(lt.LightGBMError, match="compiled parity probe"):
        lt.ServingRuntime(bp, device="cpu")


# ------------------------------------- demote, stale, bytes, warmup
@pytest.mark.parametrize("rung", sorted(RUNG_OPTS))
def test_demote_serves_the_same_bytes_until_refresh(rung):
    _, bp, X = _golden("multiclass")
    rt = lt.ServingRuntime(bp, device="cpu", **RUNG_OPTS[rung])
    before = {raw: rt.predict(X, raw_score=raw) for raw in (True, False)}
    size = rt.device_bytes()
    assert size > 0
    assert rt.demote() == size
    assert rt.demoted and rt.device_bytes() == 0 and rt.rung == rung
    assert rt.demote() == 0
    for raw in (True, False):
        assert _bits(rt.predict(X, raw_score=raw), before[raw])
    rt.refresh()
    assert not rt.demoted and rt.device_bytes() == size


def test_device_bytes_count_the_rungs_tensors():
    _, bp, _ = _golden("binary")
    sizes = {r: lt.ServingRuntime(bp, device="cpu", **o).device_bytes()
             for r, o in RUNG_OPTS.items()}
    ex = bp.export_predict_arrays()
    stacked = sum(v.numel() * v.element_size()
                  for k, v in ex["stacked"].items()
                  if k not in ("min_features", "value"))
    values = ex["value_f64"].numel() * 8
    assert sizes["slot_path"] == stacked
    assert sizes["device_sum"] == stacked + values
    assert sizes["compiled"] > sizes["device_sum"]
    assert sizes["bounded"] > sizes["compiled"]


def test_stale_after_a_change_until_refresh():
    _, bp, X = _golden("binary")
    rt = lt.ServingRuntime(bp, device="cpu")
    assert not rt.stale() and not rt.status()["stale"]
    old = rt.predict(X[:20], raw_score=True)
    bp.set_leaf_output(0, 0, bp.get_leaf_output(0, 0) + 1.0)
    assert rt.stale()
    assert _bits(rt.predict(X[:20], raw_score=True), old)  # old export
    rt.refresh()
    assert not rt.stale()
    assert _bits(rt.predict(X[:20], raw_score=True),
                 bp.predict(X[:20], raw_score=True))


@pytest.mark.parametrize("rung", sorted(RUNG_OPTS))
def test_warmup_runs_every_bucket_of_the_rung(rung):
    _, bp, X = _golden("multiclass")
    rt = lt.ServingRuntime(bp, device="cpu", max_batch_rows=8,
                           **RUNG_OPTS[rung])
    served = _cval(f"serve.{rung}")
    assert rt.buckets() == [1, 2, 4, 8]
    assert rt.warmup() == 4
    assert _cval(f"serve.{rung}") == served      # warmup is not traffic
    for n in (1, 3, 8, 9):
        got = rt.predict(X[:n], raw_score=True)
        if rung != "bounded":
            assert _bits(got, bp.predict(X[:n], raw_score=True))
