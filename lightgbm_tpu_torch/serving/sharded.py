"""The sharded serving plane: one runtime a device, the traffic striped.

The port's counterpart of `lightgbm_tpu/serving/sharded.py`
(`resolve_shard_devices` `:58`, `ShardedServingRuntime` `:73`).  Each
device of the list gets a `ServingRuntime` replica of its own, with its
own planes and launch plan on that device (`device=`), its own rungs,
probes and breakers.  A request's chunks of `max_batch_rows` rows are
assigned before any dispatch by a deterministic least-outstanding-work
rule (a snapshot of each replica's rows in flight; each chunk to the
least loaded, ties to the lowest index), then each replica serves its
chunks on a thread of its own, and the answers are put back in row
order.  Every chunk runs its replica's whole ladder, so the answer is
the one-device runtime's bit for bit whichever replica served it.

A device list may name one device more than once: that is how the CPU
tests and a one-GPU card run several replicas.  A replica whose device
fails raises and opens only its own breaker (ROADMAP Queue 3 (s)); the
other replicas go on serving their chunks.

Telemetry: the `serve.replicas` gauge, `serve.replica.<i>.outstanding`,
`serve.replica.<i>.rows` and `.<rung>` counters, the
`serve.replica.<i>.latency` histogram and the
`serving.sharded.stripe_imbalance` gauge (max / mean of the rows each
replica was routed; 1.0 is balanced).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .. import telemetry
from ..utils.locks import make_lock
from ..utils.log import LightGBMError
from .runtime import DEFAULT_MAX_BATCH_ROWS, ServingRuntime

#: the rungs from best to most degraded: a striped call reports the worst
#: its chunks used
_RUNG_ORDER = ("bounded", "compiled", "device_sum", "slot_path",
               "host_walk")


def visible_devices(device_type: Optional[str] = None) -> List[torch.device]:
    """The devices a sharded runtime may use: every GPU torch sees, or
    with `device_type="cpu"` the one CPU device."""
    if str(device_type or "cuda").lower() == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise LightGBMError("no CUDA device: sharded serving runs on the "
                            "GPUs (pass device_type='cpu' for the plain "
                            "versions)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_shard_devices(n: int, device_type: Optional[str] = None
                          ) -> List[torch.device]:
    """The devices of `serve_shard_devices=n` (0: every visible device).
    An overflow raises: a quietly smaller replica set would invalidate
    capacity planning."""
    devs = visible_devices(device_type)
    if n <= 0:
        return devs
    if n > len(devs):
        raise LightGBMError(f"serve_shard_devices={n} exceeds visible "
                            f"devices ({len(devs)})")
    return devs[:n]


class ShardedServingRuntime:
    """One model served by a `ServingRuntime` replica a device.  The
    registry and the batcher use it as a `ServingRuntime`: `predict`,
    `refresh`, `demote`, `warmup`, `device_bytes` (the sum over the
    replicas), `stale`, `status`; `num_replicas` lets the registry scale
    its per-device budget."""

    def __init__(self, booster, *, devices: Optional[List] = None,
                 shard_devices: int = 0, device_type: Optional[str] = None,
                 max_batch_rows: int = DEFAULT_MAX_BATCH_ROWS,
                 start_iteration: int = 0,
                 num_iteration: Optional[int] = None,
                 name: str = "default", device_sum: str = "auto",
                 compiled: str = "auto", precision: str = "exact",
                 quant_bits: int = 8, tile_vmem_kb: float = 512.0,
                 dispatch_timeout_ms: float = 0.0,
                 breaker_backoff_s: float = 30.0,
                 breaker_backoff_max_s: float = 600.0):
        if devices is None:
            devices = resolve_shard_devices(shard_devices, device_type)
        if not devices:
            raise LightGBMError("sharded serving needs >= 1 device")
        self._booster = booster
        self.name = name
        self.max_batch_rows = max(int(max_batch_rows), 1)
        self.devices = [torch.device(d) for d in devices]
        with telemetry.span("mesh.collective.replicate", model=name,
                            replicas=len(self.devices)):
            self._replicas = [
                ServingRuntime(booster, max_batch_rows=self.max_batch_rows,
                               start_iteration=start_iteration,
                               num_iteration=num_iteration,
                               name=f"{name}.r{i}", device_sum=device_sum,
                               compiled=compiled, precision=precision,
                               quant_bits=quant_bits,
                               tile_vmem_kb=tile_vmem_kb, device=dev,
                               dispatch_timeout_ms=dispatch_timeout_ms,
                               breaker_backoff_s=breaker_backoff_s,
                               breaker_backoff_max_s=breaker_backoff_max_s)
                for i, dev in enumerate(self.devices)]
        self._sched_lock = make_lock("serving.sharded._sched_lock")
        # rows in flight and rows routed, a replica; guarded-by _sched_lock
        self._outstanding = [0] * len(self._replicas)
        self._routed = [0] * len(self._replicas)
        telemetry.REGISTRY.gauge("serve.replicas").set(len(self._replicas))
        self._set_balance_gauges()

    # ---- the ServingRuntime surface ----
    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    @property
    def replicas(self) -> List[ServingRuntime]:
        return list(self._replicas)

    @property
    def booster(self):
        return self._booster

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def rung(self) -> str:
        return self._replicas[0].rung

    @property
    def num_class(self) -> int:
        return self._replicas[0].num_class

    @property
    def demoted(self) -> bool:
        return all(r.demoted for r in self._replicas)

    @property
    def device_sum_active(self) -> bool:
        return self._replicas[0].device_sum_active

    @property
    def compiled_active(self) -> bool:
        return self._replicas[0].compiled_active

    @property
    def precision(self) -> str:
        return self._replicas[0].precision

    @property
    def bounded_active(self) -> bool:
        # active only where every stripe can serve it
        return all(r.bounded_active for r in self._replicas)

    @property
    def bounded_bound(self):
        return self._replicas[0].bounded_bound

    @property
    def bounded_measured_error(self):
        vals = [r.bounded_measured_error for r in self._replicas]
        vals = [v for v in vals if v is not None]
        return max(vals) if vals else None

    def num_feature(self) -> int:
        return self._replicas[0].num_feature()

    def buckets(self) -> List[int]:
        return self._replicas[0].buckets()

    def stale(self) -> bool:
        return self._replicas[0].stale()

    def breaker_states(self):
        return {f"r{i}.{k}": v for i, r in enumerate(self._replicas)
                for k, v in r.breaker_states().items()}

    def status(self):
        out = self._replicas[0].status()
        out["replicas"] = [r.status() for r in self._replicas]
        out["device_bytes"] = self.device_bytes()
        return out

    def refresh(self) -> None:
        for r in self._replicas:
            r.refresh()
        telemetry.REGISTRY.gauge("serve.replicas").set(len(self._replicas))

    def demote(self) -> int:
        return sum(r.demote() for r in self._replicas)

    def device_bytes(self) -> int:
        """The bytes of every replica (a device holds its replica's
        share: the copies are the same)."""
        return sum(r.device_bytes() for r in self._replicas)

    def ledger_release(self) -> None:
        for r in self._replicas:
            r.ledger_release()

    def join_reprobes(self, timeout: Optional[float] = None) -> None:
        for r in self._replicas:
            r.join_reprobes(timeout)

    def warmup(self) -> int:
        """Each replica's buckets on its own device."""
        return sum(r.warmup() for r in self._replicas)

    # ---- striping ----
    def _assign(self, chunks: List) -> List[int]:
        """Least outstanding work, decided before any dispatch: greedy
        over a snapshot of the rows in flight, ties to the lowest
        replica."""
        with self._sched_lock:
            load = list(self._outstanding)
            assign = []
            for lo, hi in chunks:
                i = min(range(len(load)), key=lambda r: (load[r], r))
                assign.append(i)
                load[i] += hi - lo
                self._outstanding[i] += hi - lo
                self._routed[i] += hi - lo
            for i in range(len(self._replicas)):
                telemetry.REGISTRY.gauge(
                    f"serve.replica.{i}.outstanding").set(
                        self._outstanding[i])
        return assign

    def routed_rows(self) -> List[int]:
        """Rows routed to each replica so far."""
        with self._sched_lock:
            return list(self._routed)

    def _set_balance_gauges(self) -> None:
        routed = self.routed_rows()
        mean = sum(routed) / max(len(routed), 1)
        imb = (max(routed) / mean) if mean > 0 else 1.0
        telemetry.REGISTRY.gauge("serving.sharded.stripe_imbalance").set(
            round(imb, 4))

    def _run_replica(self, i: int, X: np.ndarray, my_chunks: List,
                     want_raw: bool, out_parts: dict, errors: list,
                     rungs: list) -> None:
        rep = self._replicas[i]
        lat = telemetry.REGISTRY.histogram(f"serve.replica.{i}.latency")
        rows_c = telemetry.REGISTRY.counter(f"serve.replica.{i}.rows")
        for lo, hi in my_chunks:
            clock = telemetry.StageClock()
            t0 = time.perf_counter()
            try:
                out_parts[lo] = rep.predict(X[lo:hi], raw_score=want_raw,
                                            clock=clock)
            except Exception as e:   # this replica's: the others serve on
                errors.append(e)
            finally:
                lat.observe(time.perf_counter() - t0)
                rows_c.inc(hi - lo)
                rung = clock.rung or "host_walk"
                telemetry.REGISTRY.counter(f"serve.replica.{i}.{rung}").inc()
                rungs.append((rung, clock))
                with self._sched_lock:
                    self._outstanding[i] -= hi - lo
                    telemetry.REGISTRY.gauge(
                        f"serve.replica.{i}.outstanding").set(
                            self._outstanding[i])

    def predict(self, X, raw_score: bool = False,
                clock: Optional[telemetry.StageClock] = None) -> np.ndarray:
        """Striped scores, the one-device runtime's bit for bit: the
        chunks fall at `max_batch_rows` as `ServingRuntime` cuts them,
        each runs its replica's ladder, the answers go back in row
        order.  The first error of a replica raises after every stripe
        has finished."""
        if not (isinstance(X, np.ndarray) and X.dtype == np.float64
                and X.flags["C_CONTIGUOUS"]):
            X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        n = X.shape[0]
        B = self.max_batch_rows
        chunks = [(lo, min(lo + B, n)) for lo in range(0, n, B)] or [(0, 0)]
        by_rep: dict = {}
        for (lo, hi), i in zip(chunks, self._assign(chunks)):
            by_rep.setdefault(i, []).append((lo, hi))
        out_parts: dict = {}
        errors: list = []
        rungs: list = []
        with telemetry.span("serve.sharded.predict", model=self.name,
                            rows=n, replicas=len(by_rep)):
            if len(by_rep) == 1:
                (i, mine), = by_rep.items()
                self._run_replica(i, X, mine, raw_score, out_parts, errors,
                                  rungs)
            else:
                threads = [threading.Thread(
                    target=self._run_replica,
                    args=(i, X, mine, raw_score, out_parts, errors, rungs),
                    name=f"lgbt-serve-stripe-r{i}", daemon=True)
                    for i, mine in sorted(by_rep.items())]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        self._set_balance_gauges()
        if errors:
            raise errors[0]
        if clock is not None and rungs:
            for _, cc in rungs:
                for stage, secs in cc.stages.items():
                    clock.add(stage, secs)
            clock.rung = max((r for r, _ in rungs), key=lambda r:
                             _RUNG_ORDER.index(r) if r in _RUNG_ORDER
                             else len(_RUNG_ORDER))
        parts = [out_parts[lo] for lo, _ in chunks]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
