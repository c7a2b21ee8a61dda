"""The port's sharded serving plane (`serving/sharded.py`) on the CPU,
after the JAX package's tests/test_sharded_serving.py: replicas on a
device list that names the CPU more than once, striped by least
outstanding work, each answer `Booster.predict`'s and the one-device
runtime's bit for bit.

* PARITY — every golden family through 3 replicas, bitwise; two
  replicas with ragged tails.
* STRIPING — the assignment is deterministic when quiesced and spreads
  the routed rows evenly.
* WEDGE — a replica whose device fails raises and opens only its own
  breaker (ROADMAP Queue 3 (s)); the other replicas serve on.
* BUDGET and REGISTRY — `serve_vram_budget_mb` is a device's, scaled by
  the replicas; `serve_shard_devices` loads the sharded runtime (0:
  every visible device), and more than are visible raise at `load`.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

import lightgbm_tpu_torch as lt  # noqa: E402
from golden_common import GOLDEN_CASES, make_case_data  # noqa: E402
from lightgbm_tpu_torch.resilience import FAULTS, OPEN  # noqa: E402
from lightgbm_tpu_torch.serving import (ModelRegistry,  # noqa: E402
                                        ServingDeviceError, ServingRuntime,
                                        ShardedServingRuntime,
                                        resolve_shard_devices)

PATH = {n: str(ROOT / "tests" / "data" / f"golden_{n}.model.txt")
        for n in GOLDEN_CASES}
CPU3 = ["cpu"] * 3


@pytest.fixture(autouse=True)
def one_thread():
    FAULTS.disarm()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    FAULTS.disarm()


def _golden(name):
    X, _ = make_case_data(GOLDEN_CASES[name])
    return lt.Booster(model_file=PATH[name]), X


def test_resolve_shard_devices():
    assert resolve_shard_devices(0, "cpu") == [torch.device("cpu")]
    assert resolve_shard_devices(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(lt.LightGBMError, match="exceeds visible devices"):
        resolve_shard_devices(2, "cpu")


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_family_replica_byte_parity(name):
    bst, X = _golden(name)
    sh = ShardedServingRuntime(bst, devices=CPU3, max_batch_rows=8,
                               name=f"par.{name}")
    one = ServingRuntime(bst, device="cpu", max_batch_rows=8)
    assert sh.num_replicas == 3
    for raw in (False, True):
        got = sh.predict(X, raw_score=raw)
        assert np.array_equal(got, one.predict(X, raw_score=raw))
        assert np.array_equal(got, bst.predict(X, raw_score=raw))
    assert sh.device_bytes() == 3 * one.device_bytes()


def test_two_replica_parity_and_ragged_tails():
    bst, X = _golden("regression_l2")
    sh = ShardedServingRuntime(bst, devices=["cpu", "cpu"],
                               max_batch_rows=16)
    for n in (1, 15, 16, 17, 33, len(X)):
        assert np.array_equal(sh.predict(X[:n]), bst.predict(X[:n])), n


def test_striping_is_deterministic_when_quiesced():
    bst, X = _golden("binary")
    runs = []
    for _ in range(2):
        sh = ShardedServingRuntime(bst, devices=CPU3, max_batch_rows=8)
        assign = sh._assign([(lo, lo + 8) for lo in range(0, 40, 8)])
        runs.append(assign)
    assert runs[0] == runs[1] == [0, 1, 2, 0, 1]


def test_striping_balances_routed_rows_end_to_end():
    bst, X = _golden("binary")
    sh = ShardedServingRuntime(bst, devices=CPU3, max_batch_rows=8)
    for _ in range(4):
        sh.predict(X[:48])
    routed = sh.routed_rows()
    assert sum(routed) == 4 * 48
    assert max(routed) - min(routed) <= 8


def test_one_wedged_replica_degrades_only_itself(monkeypatch):
    bst, X = _golden("binary")
    sh = ShardedServingRuntime(bst, devices=CPU3, max_batch_rows=8,
                               name="wedge")
    bad = sh.replicas[1]
    rung = bad.rung
    real = bad._dispatch

    def wedged(*a, **kw):
        raise RuntimeError("device wedged")

    monkeypatch.setattr(bad, "_dispatch", wedged)
    with pytest.raises(ServingDeviceError, match="wedged"):
        sh.predict(X[:24])
    states = sh.breaker_states()
    assert states[f"r1.{rung}"] == OPEN
    assert states[f"r0.{rung}"] != OPEN and states[f"r2.{rung}"] != OPEN
    # the healthy replicas go on answering, bitwise
    for i in (0, 2):
        assert np.array_equal(sh.replicas[i].predict(X[:8]),
                              bst.predict(X[:8]))
    monkeypatch.setattr(bad, "_dispatch", real)


def test_per_device_budget_scales_with_replicas():
    bst, X = _golden("binary")
    per = ServingRuntime(bst, device="cpu").device_bytes()
    budget_mb = (per + 4096) / (1 << 20)
    reg = ModelRegistry({"device_type": "cpu", "serve_warmup": False,
                         "serve_vram_budget_mb": budget_mb})
    try:
        # 3 copies over 3 devices: the whole exceeds one device's budget
        # but each device's share fits, so the admission passes
        rt = ShardedServingRuntime(bst, devices=CPU3)
        assert rt.device_bytes() > budget_mb * (1 << 20)
        with reg._swap_lock:
            reg._admit("wide", rt)
        entry = reg.load("m", bst, shard_devices=0)
        assert entry.runtime.num_replicas == 1
        assert np.array_equal(reg.predict(X[:16], model="m"),
                              bst.predict(X[:16]))
    finally:
        reg.close()


def test_replication_overflowing_per_device_budget_is_rejected():
    bst, _ = _golden("binary")
    per = ServingRuntime(bst, device="cpu").device_bytes()
    reg = ModelRegistry({"device_type": "cpu", "serve_warmup": False,
                         "serve_shard_devices": 0,
                         "serve_vram_budget_mb": per * 0.5 / (1 << 20)})
    try:
        with pytest.raises(lt.LightGBMError, match="keep serving"):
            reg.load("m", bst)
        assert reg.names() == []
    finally:
        reg.close()


def test_registry_builds_sharded_runtime_and_serves():
    """`serve_shard_devices=0` on the CPU: a one-replica sharded runtime,
    bitwise `Booster.predict`; a request through the batcher too."""
    bst, X = _golden("goss_bagging")
    reg = ModelRegistry({"device_type": "cpu", "serve_shard_devices": 0,
                         "serve_warmup": True, "serve_max_wait_ms": 0.0})
    try:
        entry = reg.load("g", bst)
        assert isinstance(entry.runtime, ShardedServingRuntime)
        assert entry.runtime.num_replicas == 1
        assert np.array_equal(reg.predict(X, model="g"), bst.predict(X))
        assert reg.status()["device_bytes"]["g"] == \
            entry.runtime.device_bytes()
    finally:
        reg.close()


def test_registry_overflow_raises_at_load():
    bst, _ = _golden("binary")
    reg = ModelRegistry({"device_type": "cpu"})
    try:
        reg.load("one", bst)
        with pytest.raises(lt.LightGBMError,
                           match="exceeds visible devices"):
            reg.load("two", bst, shard_devices=2)
        assert reg.names() == ["one"]
    finally:
        reg.close()
