"""The attributed device-memory ledger
(`lightgbm_tpu_torch/telemetry/memledger.py`) on the CPU, after the JAX
package's tests/test_memledger.py: registration, release and the free
seen through a weakref, views of one storage counted once, `assign`,
the Theil-Sen leak slope equal to the reference's on the same series,
the budget auditor's counters, `is_oom` on torch's texts, `oom_guard`
re-raising with its dump (also at a serving dispatch), models byte for
byte with the ledger on and off, `/debug/memory` through the port's
HTTP server, the registry's release of an unloaded model, the streamed
grower's owners, and `render_memory`.

On the CPU torch has no allocator to reconcile against (the reference
on its CPU lists `jax.live_arrays()`; torch keeps no such list), so
`reconcile()` reports `source: "none"` and no devices, as the
reference does without a backend; CPU tensors are attributed to the
`host` device.  The allocator's side (`torch.cuda.memory_stats`) is
held on the card by chip_smoke.py's train_stream and serve_plane
phases."""
import gc
import json
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from lightgbm_tpu.telemetry.memledger import (  # noqa: E402
    LeakSentinel as RefSentinel)
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.resilience import FAULTS, FaultSpec  # noqa
from lightgbm_tpu_torch.serving import (ModelRegistry, ServingClient,  # noqa
                                        ServingDeviceError, make_server)
from lightgbm_tpu_torch.telemetry import (MEMLEDGER, REGISTRY,  # noqa
                                          TRACER, MemorySink, is_oom,
                                          render_memory)
from lightgbm_tpu_torch.telemetry.memledger import LeakSentinel  # noqa

MB = 1 << 20
CPU = {"device_type": "cpu", "verbosity": -1}


@pytest.fixture(autouse=True)
def armed_ledger():
    """Each test starts from an enabled, empty ledger and leaves none."""
    MEMLEDGER.configure(enabled=True, reconcile_ms=0.0)
    MEMLEDGER.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    FAULTS.disarm()
    torch.set_num_threads(n)
    MEMLEDGER.reset()
    MEMLEDGER.configure(enabled=True, reconcile_ms=0.0)


def _owner(snap, dev, owner):
    return snap["devices"].get(dev, {}).get("owners", {}).get(
        owner, {}).get("bytes", 0)


def _train(rounds=3, **extra):
    rng = np.random.RandomState(3)
    X = rng.randn(500, 6)
    y = (X[:, 0] + 0.5 * rng.randn(500) > 0).astype(float)
    params = dict(CPU, objective="binary", num_leaves=6, **extra)
    return lt.train(params, lt.Dataset(X, label=y), rounds), X


def strip(text):
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("["))


def test_register_release_assign():
    h1 = MEMLEDGER.register("t.alpha", nbytes=3 * MB, device="dev0")
    MEMLEDGER.register("t.alpha", nbytes=1 * MB, device="dev0")
    h3 = MEMLEDGER.register("t.beta", nbytes=2 * MB, device="dev1",
                            rung="x")
    snap = MEMLEDGER.snapshot()
    assert _owner(snap, "dev0", "t.alpha") == 4 * MB
    assert _owner(snap, "dev1", "t.beta{rung=x}") == 2 * MB
    h1.release()
    h1.release()                                   # idempotent
    snap = MEMLEDGER.snapshot()
    assert _owner(snap, "dev0", "t.alpha") == 1 * MB
    assert snap["devices"]["dev0"]["peak_bytes"] == 4 * MB
    assert REGISTRY.gauge("mem.dev0.t.alpha").value == 1 * MB
    MEMLEDGER.assign("t.alpha", [])                # the rebind primitive
    snap = MEMLEDGER.snapshot()
    assert _owner(snap, "dev0", "t.alpha") == 0
    assert _owner(snap, "dev1", "t.beta{rung=x}") == 2 * MB
    h3.release()
    assert MEMLEDGER.attributed_bytes() == 0


def test_weakref_free_and_views_counted_once():
    a = torch.arange(4096, dtype=torch.float32)
    h = MEMLEDGER.register("t.weak", a)
    assert MEMLEDGER.register("t.weak", a[100:200]) is h
    assert MEMLEDGER.register("t.other", a.view(64, 64)) is h
    assert _owner(MEMLEDGER.snapshot(), "host", "t.weak") == 16384
    b = torch.zeros(10, dtype=torch.int32)
    MEMLEDGER.assign("t.weak", [b])                # replaces a's handle
    assert _owner(MEMLEDGER.snapshot(), "host", "t.weak") == 40
    del b
    gc.collect()
    assert _owner(MEMLEDGER.snapshot(), "host", "t.weak") == 0
    c = torch.ones(1000)
    MEMLEDGER.register("t.weak", c)
    del c, a
    gc.collect()                                  # no explicit release
    assert MEMLEDGER.attributed_bytes("t.") == 0


def test_disabled_ledger_is_inert():
    MEMLEDGER.configure(enabled=False)
    MEMLEDGER.register("t.off", nbytes=MB, device="dev0").release()
    assert MEMLEDGER.assign("t.off", [torch.zeros(4)]) == []
    assert not MEMLEDGER.audit("datastore_budget_mb", 1.0, 2.0)
    assert MEMLEDGER.snapshot()["devices"] == {}


def test_reconcile_on_the_cpu_has_no_allocator():
    MEMLEDGER.register("t.cpu", torch.zeros(256))
    rec = MEMLEDGER.reconcile()
    assert rec == {"source": "none", "devices": {}, "unattributed_bytes": 0,
                   "largest_unknown": []}


@pytest.mark.parametrize("series", ["flat", "linear", "sawtooth", "noisy",
                                    "ring"])
def test_leak_slope_is_the_references(series):
    rng = np.random.RandomState(1)
    n = 600 if series == "ring" else 60
    t = np.arange(n, dtype=float) * 60.0
    b = {"flat": np.full(n, 100.0 * MB),
         "linear": 100.0 * MB + np.arange(n) * 2.0 * MB,
         "sawtooth": 100.0 * MB + (np.arange(n) % 6) * 10.0 * MB,
         "noisy": 50.0 * MB + rng.rand(n) * MB + np.arange(n) * 1e4,
         "ring": 10.0 * MB + np.arange(n) * 3.0 * MB}[series]
    mine, ref = LeakSentinel(), RefSentinel()
    for ti, bi in zip(t, b):
        assert mine.observe(bi, t=ti) == ref.observe(bi, t=ti)
    assert mine.samples() == ref.samples()
    if series == "linear":
        assert mine.slope_mb_per_min() == pytest.approx(2.0, rel=1e-9)
    if series in ("flat", "sawtooth"):
        assert abs(mine.slope_mb_per_min()) < 0.05


def test_audit_counts_violations():
    c = REGISTRY.counter("mem.budget_violation",
                         contract="serve_vram_budget_mb")
    v0 = c.value
    sink = TRACER.add_sink(MemorySink())
    try:
        assert not MEMLEDGER.audit("serve_vram_budget_mb", 8 * MB, 7 * MB)
        assert c.value == v0
        assert MEMLEDGER.audit("serve_vram_budget_mb", 8 * MB, 9 * MB,
                               model="m", site="test")
        assert c.value == v0 + 1
        assert not MEMLEDGER.audit("serve_vram_budget_mb", 0, 9 * MB)
    finally:
        TRACER.remove_sink(sink)
    ev = [e for e in sink.events if e.get("name") ==
          "memory.budget_violation"]
    assert ev and ev[-1]["measured_bytes"] == 9 * MB
    assert MEMLEDGER.snapshot()["budget_violations"][
        "contract=serve_vram_budget_mb"] == c.value


def test_is_oom_on_torch_texts():
    assert is_oom(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert is_oom(RuntimeError("CUDA out of memory."))
    assert is_oom(RuntimeError("RESOURCE_EXHAUSTED: while allocating"))
    assert is_oom(MemoryError("out of memory"))
    assert not is_oom(ValueError("shape mismatch"))


def test_oom_guard_reraises_with_its_dump():
    MEMLEDGER.register("t.big", nbytes=7 * MB, device="dev0")
    MEMLEDGER.register("t.small", nbytes=MB, device="dev0")
    d0 = REGISTRY.counter("mem.oom.dumps").value
    sink = TRACER.add_sink(MemorySink())
    try:
        with pytest.raises(torch.cuda.OutOfMemoryError):
            with MEMLEDGER.oom_guard("t.site"):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        with pytest.raises(ValueError):
            with MEMLEDGER.oom_guard("t.site2"):
                raise ValueError("not an oom")
    finally:
        TRACER.remove_sink(sink)
    assert REGISTRY.counter("mem.oom.dumps").value == d0 + 1
    (ev,) = [e for e in sink.events if e.get("ev") == "oom"]
    assert ev["name"] == "t.site"
    assert [o["owner"] for o in ev["top_owners"]] == ["dev0:t.big",
                                                      "dev0:t.small"]
    assert sum(ev["devices"]["dev0"]["owners"].values()) == 8 * MB


def test_oom_at_a_serving_dispatch_is_dumped_and_raised():
    """The port does not fall through a failing rung: the request raises
    `ServingDeviceError`, and the dump names the serving planes."""
    bst, X = _train()
    rt = lt.ServingRuntime(bst, name="oomtest", device="cpu")
    d0 = REGISTRY.counter("mem.oom.dumps").value
    sink = TRACER.add_sink(MemorySink())
    FAULTS.arm(FaultSpec(f"serve.dispatch.{rt.rung}", "error",
                         arg="CUDA out of memory. Tried to allocate 1 GiB"))
    try:
        with pytest.raises(ServingDeviceError):
            rt.predict(X[:16])
    finally:
        FAULTS.disarm()
        TRACER.remove_sink(sink)
    assert REGISTRY.counter("mem.oom.dumps").value == d0 + 1
    (ev,) = [e for e in sink.events if e.get("ev") == "oom"]
    assert ev["name"] == f"serve.dispatch.{rt.rung}"
    assert ev["model"] == "oomtest" and "out of memory" in ev["error"]
    owners = ev["devices"]["host"]["owners"]
    assert any(k.startswith("serve.oomtest.planes") and b > 0
               for k, b in owners.items())
    assert sum(owners.values()) == ev["devices"]["host"]["attributed_bytes"]


def test_models_byte_for_byte_with_the_ledger_on_and_off():
    on, X = _train(memory_ledger=True)
    assert MEMLEDGER.attributed_bytes("train.scores") > 0
    MEMLEDGER.reset()
    off, _ = _train(memory_ledger=False)
    assert MEMLEDGER.snapshot()["devices"] == {}
    assert strip(on.model_to_string()) == strip(off.model_to_string())
    assert np.array_equal(on.predict(X), off.predict(X))


def test_debug_memory_over_http_and_render():
    import threading
    bst, X = _train()
    client = ServingClient(bst, params=dict(CPU, serve_warmup=False))
    srv = make_server(client, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/debug/memory"
        resp = urllib.request.urlopen(url, timeout=60)
        assert resp.status == 200
        body = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(60)
        client.close()
    owners = body["devices"]["host"]["owners"]
    planes = {k: v for k, v in owners.items()
              if k.startswith("serve.default.planes")}
    assert planes and sum(v["bytes"] for v in planes.values()) > 0
    assert body["reconcile"]["source"] == "none"
    text = render_memory(body)
    assert "serve.default.planes" in text and "budget violations" in text
    json.dumps(body)


def test_registry_close_releases_the_models_attribution():
    bst, X = _train()
    reg = ModelRegistry(params=CPU)
    try:
        reg.load("gone", bst)
        reg.predict(X[:8], model="gone")
        assert MEMLEDGER.attributed_bytes("serve.gone.") > 0
    finally:
        reg.close()
    assert MEMLEDGER.attributed_bytes("serve.gone.") == 0


def test_streamed_training_owners():
    REGISTRY.gauge("stream.peak_device_mb").set(0.0)
    REGISTRY.gauge("stream.peak_staging_mb").set(0.0)
    seen = set()
    orig = MEMLEDGER.register

    def spy(owner, array=None, **kw):
        seen.add(owner)
        return orig(owner, array, **kw)

    MEMLEDGER.register = spy
    try:
        bst, _ = _train(rounds=2, external_memory=True,
                        streaming_train="on", datastore_shard_rows=128)
    finally:
        del MEMLEDGER.register
    assert bst._streaming is not None
    assert {"stream.staging", "train.hist_carry", "train.scores"} <= seen
    staging = REGISTRY.gauge("stream.peak_staging_mb").value
    assert 0 < staging <= REGISTRY.gauge("stream.peak_device_mb").value
    owners = MEMLEDGER.snapshot()["devices"]["host"]["owners"]
    assert owners["train.scores{buf=stream}"]["peak_bytes"] > 0
    assert owners["train.hist_carry"]["peak_bytes"] > 0
