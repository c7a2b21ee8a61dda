"""The port's serving plane around the runtime: the micro-batcher, the
model registry, the HTTP front end, request traces and the resilience
units (fault plane, watchdog, breaker), on the CPU.

Answers are held to `Booster.predict` bitwise (the runtime's rungs are
held to the JAX package's in test_torch_serving_ladder.py).  Every wait
is on an event, a join or an injected clock, never on a sleep: the
batcher's worker is held inside `predict` by a gate until the test has
queued what it needs.
"""
import http.client
import json
import socket
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu_torch as lt  # noqa: E402
import lightgbm_tpu_torch.serving.batcher as batcher_mod  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu_torch import telemetry  # noqa: E402
from lightgbm_tpu_torch.resilience import (  # noqa: E402
    CLOSED, FAULTS, HALF_OPEN, OPEN, PERMANENT, CircuitBreaker,
    DeviceTimeoutError, FaultInjected, FaultPlane, FaultSpec, Supervisor)
from lightgbm_tpu_torch.serving import (  # noqa: E402
    MicroBatcher, ModelRegistry, ServingClient, ServingClosedError,
    ServingOverloadError, make_server)
from lightgbm_tpu_torch.serving import registry as registry_mod  # noqa
from lightgbm_tpu_torch.serving.http import ServingHTTPHandler  # noqa: E402

CPU = {"device_type": "cpu"}
PATH = {n: str(ROOT / "tests" / "data" / f"golden_{n}.model.txt")
        for n in GOLDEN_CASES}


@pytest.fixture(autouse=True)
def clean_faults_and_one_thread():
    FAULTS.disarm()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        FAULTS.disarm()
        torch.set_num_threads(n)


def _golden(name):
    X, _ = make_case_data(GOLDEN_CASES[name])
    return lt.Booster(model_file=PATH[name]), X


def _cval(name, **labels):
    return telemetry.REGISTRY.counter(name, **labels).value


class _Gate:
    """Wraps a runtime's predict so the batcher's worker parks inside it
    until `release()`: `entered` is set once it is parked."""

    def __init__(self, rt):
        self.inner = rt.predict
        self.entered = threading.Event()
        self.go = threading.Event()
        self.calls = []
        rt.predict = self

    def __call__(self, X, raw_score=False, clock=None):
        self.calls.append(X.shape[0])
        self.entered.set()
        assert self.go.wait(60)
        return self.inner(X, raw_score=raw_score, clock=clock)

    def release(self):
        self.go.set()


# ---------------------------------------------------------- the batcher
def test_batcher_coalesces_queued_requests():
    bst, X = _golden("binary")
    rt = lt.ServingRuntime(bst, device="cpu")
    gate = _Gate(rt)
    before = _cval("serve.batches")
    # the queued requests are all there when the worker comes back, so
    # the wait only bounds how long it looks for more
    with MicroBatcher(rt, max_wait_ms=20.0) as b:
        first = b.submit(X[:4])
        assert gate.entered.wait(60)
        reqs = [b.submit(X[i * 4:(i + 1) * 4]) for i in range(1, 12)]
        gate.release()
        outs = [first.wait(60)] + [r.wait(60) for r in reqs]
    for i, out in enumerate(outs):
        assert np.array_equal(out, bst.predict(X[i * 4:(i + 1) * 4]))
    assert _cval("serve.batches") - before == 2
    assert gate.calls == [4, 44]


def test_batcher_mixed_raw_and_prob_groups():
    bst, X = _golden("binary")
    rt = lt.ServingRuntime(bst, device="cpu")
    gate = _Gate(rt)
    with MicroBatcher(rt, max_wait_ms=20.0) as b:
        r0 = b.submit(X[:2])
        assert gate.entered.wait(60)
        r1 = b.submit(X[:16], raw_score=True)
        r2 = b.submit(X[16:32], raw_score=False)
        gate.release()
        assert np.array_equal(r0.wait(60), bst.predict(X[:2]))
        assert np.array_equal(r1.wait(60),
                              bst.predict(X[:16], raw_score=True))
        assert np.array_equal(r2.wait(60), bst.predict(X[16:32]))
    assert gate.calls == [2, 16, 16]          # one flush, two groups


def test_batcher_sheds_on_full_queue():
    bst, X = _golden("binary")
    rt = lt.ServingRuntime(bst, device="cpu")
    gate = _Gate(rt)
    shed = _cval("serve.shed.queue_full")
    with MicroBatcher(rt, max_wait_ms=0.0, queue_depth=1) as b:
        first = b.submit(X[:2])
        assert gate.entered.wait(60)
        queued = b.submit(X[:2])               # fills the queue
        with pytest.raises(ServingOverloadError, match="queue full"):
            b.submit(X[:2])
        gate.release()
        assert np.array_equal(first.wait(60), queued.wait(60))
    assert _cval("serve.shed.queue_full") == shed + 1


def test_queue_full_sheds_attributed_to_swap_window():
    bst, X = _golden("binary")

    def flood():
        rt = lt.ServingRuntime(bst, device="cpu")
        gate = _Gate(rt)
        with MicroBatcher(rt, max_wait_ms=0.0, queue_depth=1) as b:
            b.submit(X[:2])
            assert gate.entered.wait(60)
            b.submit(X[:2])
            with pytest.raises(ServingOverloadError):
                b.submit(X[:2])
            gate.release()

    swap = telemetry.REGISTRY.counter("serve.shed.swap_window")
    base = swap.value
    with registry_mod._swap_window():
        assert telemetry.REGISTRY.gauge("serve.swap_windows").value >= 1
        flood()
    assert swap.value == base + 1
    assert telemetry.REGISTRY.gauge("serve.swap_windows").value == 0
    flood()
    assert swap.value == base + 1


def test_batcher_deadline_shedding(monkeypatch):
    bst, X = _golden("binary")
    rt = lt.ServingRuntime(bst, device="cpu")
    gate = _Gate(rt)
    now = [1000.0]
    monkeypatch.setattr(batcher_mod, "time", types.SimpleNamespace(
        monotonic=lambda: now[0], perf_counter=time.perf_counter))
    shed = _cval("serve.shed.deadline")
    with MicroBatcher(rt, max_wait_ms=0.0, deadline_ms=5.0) as b:
        first = b.submit(X[:4])
        assert gate.entered.wait(60)
        late = b.submit(X[:4])
        now[0] += 1.0                          # its deadline passes queued
        gate.release()
        assert np.array_equal(first.wait(60), bst.predict(X[:4]))
        with pytest.raises(ServingOverloadError, match="deadline"):
            late.wait(60)
    assert _cval("serve.shed.deadline") == shed + 1


def test_batcher_worker_restarts_after_a_loop_crash():
    bst, X = _golden("binary")
    rt = lt.ServingRuntime(bst, device="cpu")
    restarts = _cval("serve.batcher.worker_restarts")
    FAULTS.arm("serve.flush:error@n=1")
    with MicroBatcher(rt, max_wait_ms=0.0) as b:
        with pytest.raises(ServingClosedError, match="crashed"):
            b.predict(X[:3], timeout=60)
        # the loop restarted: the next request is served
        assert np.array_equal(b.predict(X[:3], timeout=60),
                              bst.predict(X[:3]))
    assert _cval("serve.batcher.worker_restarts") == restarts + 1


def test_batcher_close_fails_queued_requests():
    bst, X = _golden("binary")
    rt = lt.ServingRuntime(bst, device="cpu")
    gate = _Gate(rt)
    b = MicroBatcher(rt, max_wait_ms=0.0)
    first = b.submit(X[:2])
    assert gate.entered.wait(60)
    queued = b.submit(X[:2])
    # close() marks the batcher closed, then joins the worker: release
    # the worker only once it is closed, so the queued request sees it
    closing = threading.Event()
    join = b._worker.join
    b._worker.join = lambda timeout=None: (closing.set(), join(timeout))
    closer = threading.Thread(target=b.close, kwargs={"timeout": 60})
    closer.start()
    assert closing.wait(60)
    gate.release()
    closer.join(60)
    assert not closer.is_alive()
    assert np.array_equal(first.wait(60), bst.predict(X[:2]))
    with pytest.raises(ServingClosedError):
        queued.wait(60)
    with pytest.raises(ServingClosedError):
        b.submit(X[:2])


# --------------------------------------------------------- the registry
def test_registry_load_swap_unload():
    b1, X1 = _golden("binary")
    b2, X2 = _golden("goss_bagging")
    reg = ModelRegistry(dict(CPU, serve_warmup=False))
    try:
        reg.load("m", PATH["binary"])
        assert reg.names() == ["m"]
        assert np.array_equal(reg.predict(X1[:16], model="m"),
                              b1.predict(X1[:16]))
        old = reg.get("m")
        reg.load("m", b2)                       # atomic hot-swap
        assert reg.get("m") is not old
        assert np.array_equal(reg.predict(X2[:16], model="m"),
                              b2.predict(X2[:16]))
        with pytest.raises(ServingClosedError):
            old.batcher.submit(X1[:2])          # the old entry drained
        with pytest.raises(lt.LightGBMError, match="no model"):
            reg.predict(X1[:2], model="ghost")
        reg.unload("m")
        assert reg.names() == []
    finally:
        reg.close()


def _device_bytes(name):
    return lt.ServingRuntime(lt.Booster(model_file=PATH[name]),
                             device="cpu").device_bytes()


def test_registry_budget_lru_demotes_then_serves():
    b_small, b_big = _device_bytes("binary"), _device_bytes("multiclass")
    budget_mb = max(b_small, b_big) / float(1 << 20)
    dem = _cval("serve.demotions")
    reg = ModelRegistry(dict(CPU, serve_warmup=False,
                             serve_vram_budget_mb=budget_mb))
    try:
        reg.load("small", PATH["binary"])
        reg.load("big", PATH["multiclass"])     # LRU-demotes "small"
        assert _cval("serve.demotions") == dem + 1
        st = reg.status()
        assert st["models"] == ["big", "small"]
        assert st["demoted"] == ["small"]
        assert st["device_bytes"] == {"big": b_big, "small": 0}
        bs, Xs = _golden("binary")
        bb, Xb = _golden("multiclass")
        assert np.array_equal(reg.predict(Xs[:64], model="small"),
                              bs.predict(Xs[:64]))
        assert np.array_equal(reg.predict(Xb[:64], model="big"),
                              bb.predict(Xb[:64]))
        reg.get("small").runtime.refresh()      # promoted again
        assert reg.status()["demoted"] == []
    finally:
        reg.close()


def test_registry_budget_rejects_unfittable_load():
    sizes = {n: _device_bytes(n) for n in ("binary", "multiclass")}
    small = min(sizes, key=sizes.get)
    big = max(sizes, key=sizes.get)
    assert sizes[small] < sizes[big]
    budget_mb = ((sizes[small] + sizes[big]) // 2) / float(1 << 20)
    reg = ModelRegistry(dict(CPU, serve_warmup=False,
                             serve_vram_budget_mb=budget_mb))
    try:
        reg.load("small", PATH[small])
        with pytest.raises(lt.LightGBMError, match="keep serving"):
            reg.load("big", PATH[big])
        assert reg.names() == ["small"]
        bs, Xs = _golden(small)
        assert np.array_equal(reg.predict(Xs[:64], model="small"),
                              bs.predict(Xs[:64]))
    finally:
        reg.close()


def test_registry_staleness_and_auto_refresh():
    bst, X = _golden("binary")
    reg = ModelRegistry(dict(CPU, serve_warmup=False,
                             serve_auto_refresh=True))
    kicks = _cval("serve.auto_refresh")
    try:
        reg.load("m", bst)
        assert reg.status()["stale"] == []
        old = reg.predict(X[:32], model="m", raw_score=True)
        bst.set_leaf_output(0, 0, bst.get_leaf_output(0, 0) + 0.5)
        assert reg.status()["stale"] == ["m"]
        assert telemetry.REGISTRY.gauge("serve.stale").value == 1
        # this request kicks the background refresh and is answered by
        # the export it found (the refresh may or may not have landed)
        got = reg.predict(X[:32], model="m", raw_score=True)
        assert np.array_equal(got, old) or np.array_equal(
            got, bst.predict(X[:32], raw_score=True))
        assert _cval("serve.auto_refresh") == kicks + 1
        reg.get("m").join_refresh(timeout=60)
        assert reg.status()["stale"] == []
        assert telemetry.REGISTRY.gauge("serve.stale").value == 0
        assert np.array_equal(reg.predict(X[:32], model="m", raw_score=True),
                              bst.predict(X[:32], raw_score=True))
    finally:
        reg.close()


def test_registry_warmup_on_load(monkeypatch):
    warmed = []
    orig = lt.ServingRuntime.warmup
    monkeypatch.setattr(lt.ServingRuntime, "warmup",
                        lambda self: warmed.append(orig(self)) or warmed[-1])
    reg = ModelRegistry(dict(CPU, serve_max_batch_rows=8))
    try:
        reg.load("w", PATH["binary"])
        assert warmed == [4]                    # buckets 1, 2, 4, 8
        reg.load("cold", PATH["binary"], warmup=False)
        assert warmed == [4]
    finally:
        reg.close()


def test_registry_samplers_see_requests_and_never_fail_them():
    bst, X = _golden("binary")
    reg = ModelRegistry(dict(CPU, serve_warmup=False))
    seen = []

    def broken(_X):
        raise RuntimeError("sampler bug")

    try:
        reg.load("m", bst)
        reg.attach_sampler("m", lambda x: seen.append(x.shape))
        reg.attach_sampler("m", broken)
        errors = _cval("serve.sampler_errors")
        assert np.array_equal(reg.predict(X[:7], model="m"),
                              bst.predict(X[:7]))
        assert seen == [(7, X.shape[1])]
        assert _cval("serve.sampler_errors") == errors + 1
        reg.detach_sampler("m")
        reg.predict(X[:7], model="m")
        assert seen == [(7, X.shape[1])]
    finally:
        reg.close()


def test_registry_refuses_sharded_serving():
    with pytest.raises(lt.LightGBMError, match="5f"):
        ModelRegistry(dict(CPU, serve_shard_devices=2))


# -------------------------------------------------------------- HTTP
def _serve(client):
    srv = make_server(client, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, t, client):
    srv.shutdown()
    srv.server_close()
    t.join(60)
    client.close()


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    resp = urllib.request.urlopen(req, timeout=60)
    return resp, json.loads(resp.read())


def _get(url):
    return json.loads(urllib.request.urlopen(url, timeout=60).read())


def _code(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value


def test_http_predict_healthz_metrics_and_traces():
    bst, X = _golden("binary")
    client = ServingClient(bst, params=dict(CPU, serve_warmup=False,
                                            serve_trace_slow_ms=0.0))
    telemetry.SERVE_RECORDER.clear()
    srv, t, base = _serve(client)
    try:
        resp, body = _post(f"{base}/predict",
                           {"rows": X[:256].tolist(), "raw_score": True},
                           headers={"X-Request-Id": "plane-1"})
        assert resp.headers["X-Request-Id"] == "plane-1"
        assert body["request_id"] == "plane-1" and body["rows"] == 256
        got = np.asarray(body["predictions"])
        want = bst.predict(X[:256], raw_score=True)
        assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
        _, conv = _post(f"{base}/predict", {"rows": X[:9].tolist()})
        assert np.array_equal(np.asarray(conv["predictions"], np.float32),
                              bst.predict(X[:9]))
        hz = _get(f"{base}/healthz")
        assert hz["status"] == "ok" and hz["models"] == ["default"]
        assert hz["stale"] == [] and hz["demoted"] == []
        assert hz["device_bytes"]["default"] > 0
        assert hz["rungs"]["default"]["rung"] == "compiled"
        assert set(hz["rungs"]["default"]["breakers"].values()) == {CLOSED}
        assert hz["latency_ms"]["count"] >= 1
        metrics = urllib.request.urlopen(f"{base}/metrics",
                                         timeout=60).read().decode()
        assert "lgbm_tpu_serve_stage_e2e_seconds_bucket{" in metrics
        assert "lgbm_tpu_serve_rows" in metrics
        dbg = _get(f"{base}/debug/requests")
        tr = next(x for x in dbg["requests"] if x["id"] == "plane-1")
        assert tr["status"] == "ok" and tr["rows"] == 256
        assert tr["rung"] == "compiled"
        stages = tr["stages_ms"]
        assert {"queue_wait", "coalesce", "stage_copy", "dispatch", "d2h",
                "convert", "finish"} <= set(stages)
        total = sum(stages.values())
        # disjoint sub-intervals of the request's window
        assert total <= tr["e2e_ms"] * 1.01 + 0.1
        assert total >= tr["e2e_ms"] - 50.0 * (len(stages) + 1)
        assert len(_get(f"{base}/debug/requests?n=1")["requests"]) == 1
    finally:
        _stop(srv, t, client)


def test_http_responses_leave_without_nagle(monkeypatch):
    # headers and body leave in two sends: without TCP_NODELAY the body
    # waits for the client's delayed ACK of the headers
    seen = []
    orig = ServingHTTPHandler.setup

    def setup(self):
        orig(self)
        seen.append(self.connection.getsockopt(socket.IPPROTO_TCP,
                                               socket.TCP_NODELAY))

    monkeypatch.setattr(ServingHTTPHandler, "setup", setup)
    bst, X = _golden("binary")
    client = ServingClient(bst, params=dict(CPU, serve_warmup=False))
    srv, t, base = _serve(client)
    try:
        _, body = _post(f"{base}/predict", {"rows": X[:3].tolist()})
        assert body["rows"] == 3
        assert _get(f"{base}/healthz")["status"] == "ok"
    finally:
        _stop(srv, t, client)
    assert len(seen) == 2 and all(seen)


def test_http_error_codes():
    bst, X = _golden("binary")
    client = ServingClient(bst, params=dict(CPU, serve_warmup=False,
                                            serve_max_body_mb=0.001,
                                            serve_breaker_backoff_s=7.0))
    srv, t, base = _serve(client)
    try:
        assert _code(lambda: _post(f"{base}/predict", {"oops": 1})
                     ).code == 400
        assert _code(lambda: _post(f"{base}/predict",
                                   {"rows": [[1, 2], [3]]})).code == 400
        assert _code(lambda: _get(f"{base}/debug/requests?n=x")).code == 400
        assert _code(lambda: _get(f"{base}/debug/requests?n=-1")).code == 400
        assert _code(lambda: _post(f"{base}/predict",
                                   {"rows": X[:2].tolist(),
                                    "model": "ghost"})).code == 404
        assert _code(lambda: _get(f"{base}/nowhere")).code == 404
        e = _code(lambda: _get(base + "/debug/fleet"))
        assert e.code == 404 and "5g" in e.read().decode()
        mem = _get(base + "/debug/memory")
        assert mem["reconcile"]["source"] == "none" and "devices" in mem
        # 413 before the body is read: only the headers are sent
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.server_address[1], timeout=60)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", str(1 << 30))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        conn.close()
        # a device error: 503 with Retry-After, then the open breaker
        FAULTS.arm("serve.dispatch.compiled:error")
        for expect in ("failed", "breaker"):
            e = _code(lambda: _post(f"{base}/predict",
                                    {"rows": X[:2].tolist()}))
            assert e.code == 503 and e.headers["Retry-After"] == "7"
            assert expect in json.loads(e.read())["error"]
        FAULTS.disarm()
        hz = _get(f"{base}/healthz")
        assert hz["rungs"]["default"]["breakers"]["compiled"] == OPEN
    finally:
        _stop(srv, t, client)


def test_http_overload_is_503():
    bst, X = _golden("binary")
    client = ServingClient(params=dict(CPU, serve_warmup=False,
                                       serve_queue_depth=1,
                                       serve_max_wait_ms=0.0))
    client.load("default", bst)
    gate = _Gate(client.registry.get("default").runtime)
    srv, t, base = _serve(client)
    try:
        held = client.registry.get("default").batcher.submit(X[:2])
        assert gate.entered.wait(60)
        queued = client.registry.get("default").batcher.submit(X[:2])
        e = _code(lambda: _post(f"{base}/predict", {"rows": X[:2].tolist()}))
        assert e.code == 503 and e.headers["Retry-After"] == "1"
        gate.release()
        held.wait(60)
        queued.wait(60)
    finally:
        _stop(srv, t, client)


def test_tracing_does_not_change_predictions():
    bst, X = _golden("multiclass")
    for on in (True, False):
        client = ServingClient(bst, params=dict(CPU, serve_warmup=False,
                                                serve_trace=on))
        try:
            got = client.predict(X[:50], raw_score=True)
            assert np.array_equal(got, bst.predict(X[:50], raw_score=True))
            assert telemetry.SERVE_RECORDER.snapshot()["enabled"] == on
        finally:
            client.close()


# ------------------------------------------ resilience units (the JAX
# package's tests/test_resilience.py fault-plane, supervisor and breaker
# cases, on the port's copies)
class TestFaultPlane:
    def test_parse_grammar(self):
        s = FaultSpec.parse("serve.d2h.*:corrupt@p=0.5@n=3@after=2")
        assert s.pattern == "serve.d2h.*" and s.mode == "corrupt"
        assert s.p == 0.5 and s.n == 3 and s.after == 2
        s2 = FaultSpec.parse("serve.dispatch.compiled:delay:0.05")
        assert s2.mode == "delay" and s2.arg == 0.05
        for bad in ("no-mode-here", "site:explode", "site:error@bogus=1"):
            with pytest.raises(ValueError):
                FaultSpec.parse(bad)

    def test_error_and_counting(self):
        fp = FaultPlane(env="")
        fp.arm("a.b:error")
        assert fp.inject("other.site") is None
        with pytest.raises(FaultInjected):
            fp.inject("a.b")
        assert fp.fired["a.b:error"] == 1
        assert fp.fired_at("a.") == 1

    def test_n_and_after_modifiers(self):
        fp = FaultPlane(env="")
        fp.arm("x:error@after=2@n=1")
        fp.inject("x")
        fp.inject("x")
        with pytest.raises(FaultInjected):
            fp.inject("x")
        fp.inject("x")
        assert fp.fired["x:error"] == 1

    def test_glob_sites_and_accumulation(self):
        fp = FaultPlane(env="")
        fp.arm("serve.dispatch.*:error")
        fp.arm("serve.flush:error")
        assert len(fp.specs()) == 2
        for site in ("serve.dispatch.device_sum", "serve.dispatch.slot_path",
                     "serve.flush"):
            with pytest.raises(FaultInjected):
                fp.inject(site)
        fp.disarm()
        assert not fp.active()
        fp.inject("serve.flush")

    def test_corrupt_flips_copy_not_original(self):
        fp = FaultPlane(env="")
        fp.arm("d2h:corrupt")
        orig = np.arange(4, dtype=np.float64)
        keep = orig.copy()
        bad = fp.inject("d2h", orig)
        assert not np.array_equal(bad, orig)
        np.testing.assert_array_equal(orig, keep)
        assert fp.inject("d2h", None) is None

    def test_disarm_releases_hang(self):
        fp = FaultPlane(env="")
        fp.arm("slow:hang")
        parked = threading.Event()
        released = threading.Event()

        def hang():
            parked.set()
            fp.inject("slow")
            released.set()

        t = threading.Thread(target=hang, daemon=True)
        t.start()
        assert parked.wait(60)
        assert not released.wait(0.05)
        fp.disarm()
        assert released.wait(60)
        t.join(60)
        assert not t.is_alive()

    def test_env_var_arming(self, monkeypatch):
        monkeypatch.setenv("LGBM_FAULTS", "a:error,b:delay:0.001")
        fp = FaultPlane()
        assert {s.pattern for s in fp.specs()} == {"a", "b"}


class TestSupervisor:
    def test_zero_timeout_is_direct(self):
        sup = Supervisor("t.direct", 0.0)
        assert not sup.enabled
        assert sup.call(lambda a, b: a + b, 2, 3) == 5

    def test_result_and_exception_propagate(self):
        sup = Supervisor("t.prop", 5000.0)
        assert sup.call(lambda: 42) == 42
        with pytest.raises(KeyError):
            sup.call(dict().__getitem__, "missing")

    def test_timeout_raises_and_counts_then_recovers(self):
        sup = Supervisor("t.hang", 100.0)
        fired = _cval("serve.watchdog.fired", site="t.hang")
        ev = threading.Event()
        with pytest.raises(DeviceTimeoutError):
            sup.call(ev.wait, 30.0)
        assert _cval("serve.watchdog.fired", site="t.hang") == fired + 1
        ev.set()
        assert sup.call(lambda: "ok") == "ok"

    def test_timeout_error_is_lightgbm_error(self):
        assert issubclass(DeviceTimeoutError, lt.LightGBMError)


class TestCircuitBreaker:
    def test_full_lifecycle_with_injected_clock(self):
        now = [0.0]
        br = CircuitBreaker("t.rung", backoff_s=10.0, backoff_max_s=25.0,
                            clock=lambda: now[0])
        assert br.state == CLOSED and br.allow_request()
        br.record_failure()
        assert br.state == OPEN and not br.allow_request()
        assert not br.begin_probe()
        now[0] = 10.0
        assert br.begin_probe()
        assert br.state == HALF_OPEN
        assert not br.begin_probe()
        br.record_failure()
        assert br.state == OPEN
        now[0] = 25.0
        assert not br.begin_probe()
        now[0] = 30.0
        assert br.begin_probe()
        br.record_failure()
        now[0] = 54.0
        assert not br.begin_probe()
        now[0] = 55.0
        assert br.begin_probe()
        br.record_success()
        assert br.state == CLOSED and br.failures == 0
        br.record_failure()
        now[0] = 65.0
        assert br.begin_probe()

    def test_mismatch_is_permanent_until_reset(self):
        br = CircuitBreaker("t.mis", backoff_s=0.0, clock=lambda: 1e9)
        br.record_mismatch()
        assert br.state == PERMANENT
        assert not br.begin_probe()
        br.record_failure()
        assert br.state == PERMANENT
        br.reset()
        assert br.state == CLOSED

    def test_transitions_are_counted(self):
        br = CircuitBreaker("t.count", backoff_s=1.0, clock=lambda: 0.0)
        opened = _cval("serve.breaker.transitions", breaker="t.count",
                       state=OPEN)
        br.record_failure()
        assert _cval("serve.breaker.transitions", breaker="t.count",
                     state=OPEN) == opened + 1
        assert telemetry.REGISTRY.gauge("serve.breaker.state",
                                        breaker="t.count").value == 2
