"""Multi-model registry: warm-up-on-load, atomic hot-swap, budgeting.

The port's copy of `lightgbm_tpu/serving/registry.py`.  `load()` builds
the full serving stack for a model — export, optional all-bucket
warm-up, micro-batcher — **before** the name becomes visible, then
swaps it in under the registry lock.  A hot-swap therefore never serves
a cold model: readers resolve either the whole old entry or the whole
new one, and the old entry's batcher is closed only after the swap
(in-flight requests on it complete).

Co-residency budgeting (`serve_vram_budget_mb`, 0 = unlimited): each
entry accounts its runtime's resident device bytes
(`ServingRuntime.device_bytes`).  A load that would exceed the budget
first DEMOTES least-recently-used entries (their tensors move to host
copies — they keep serving bit-identical results on the same rung,
uploading per call, until a `refresh()` promotes them again) and, if
still over, is rejected with a clear `LightGBMError` while every
already-loaded model keeps serving.

Staleness: `status()` reports entries whose booster changed since their
last export (`ServingRuntime.stale`) — surfaced in `/healthz` and the
`serve.stale` gauge; with `serve_auto_refresh` the first predict that
notices it starts a BACKGROUND re-export (the stale export keeps serving
until the refreshed one swaps in), so the request thread never pays it.

The runtimes serve on `device_type` ("cuda" by default; "cpu" runs the
plain versions).  `serve_shard_devices` other than 1 loads a
`ShardedServingRuntime` (a replica a device, 0: every visible device;
more than are visible raises at `load`), and the budget, a device's,
scales with its replicas.  The lineage ledger's records wait for item
5g.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Union

from .. import telemetry
from ..resilience import FAULTS
from ..utils.config import Config
from ..utils.locks import make_lock
from ..utils.log import LightGBMError
from .batcher import MicroBatcher, ServingClosedError
from .runtime import ServingRuntime
from .sharded import ShardedServingRuntime

#: bound on back-to-back hot-swap retries in `predict` — each retry
#: requires ANOTHER swap to have landed mid-dispatch, so a healthy
#: registry never comes close; the bound turns a pathological
#: swap-storm into a clean error instead of an unbounded loop
_SWAP_RETRIES = 8

# process-wide count of build-then-swap loads currently in flight,
# published as the `serve.swap_windows` gauge.  The batcher reads the
# gauge on every shed to attribute it (`serve.shed.swap_window`).
_swap_window_lock = threading.Lock()
_swap_window_count = 0


def _note_swap_window(delta: int) -> None:
    global _swap_window_count
    with _swap_window_lock:
        _swap_window_count = max(0, _swap_window_count + delta)
        count = _swap_window_count
    telemetry.REGISTRY.gauge("serve.swap_windows").set(count)


@contextlib.contextmanager
def _swap_window():
    """Marks one build-then-swap window (runtime build, warmup, swap):
    the phase whose device/CPU contention makes concurrent sheds
    swap-cost rather than steady-state load."""
    _note_swap_window(1)
    try:
        yield
    finally:
        _note_swap_window(-1)


class ServingModel:
    """One registered model: its runtime + micro-batcher."""

    def __init__(self, name: str, runtime: ServingRuntime,
                 batcher: MicroBatcher, auto_refresh: bool = False):
        self.name = name
        self.runtime = runtime
        self.batcher = batcher
        self.auto_refresh = auto_refresh
        self.last_used = time.monotonic()
        self._refresh_kick = make_lock("serving.registry._refresh_kick")
        self._refresh_thread: Optional[threading.Thread] = None

    def predict(self, X, raw_score: bool = False,
                timeout: Optional[float] = None,
                trace: Optional[telemetry.RequestTrace] = None):
        self.last_used = time.monotonic()
        if self.auto_refresh and self.runtime.stale():
            # OFF the request thread: a re-export costs uploads and the
            # rung's probe, which must never land in a request's p99
            self._kick_refresh()
        return self.batcher.predict(X, raw_score=raw_score,
                                    timeout=timeout, trace=trace)

    def _kick_refresh(self) -> None:
        """Start (at most) one background refresh; callers never wait."""
        with self._refresh_kick:
            t = self._refresh_thread
            if t is not None and t.is_alive():
                return
            telemetry.REGISTRY.counter("serve.auto_refresh").inc()
            t = threading.Thread(
                target=self._background_refresh,
                name=f"lgbm-serve-refresh-{self.name}", daemon=True)
            self._refresh_thread = t
            t.start()

    def _background_refresh(self) -> None:
        try:
            self.runtime.refresh()
        except Exception as e:  # a failed refresh must not kill serving
            telemetry.REGISTRY.counter("serve.auto_refresh_errors").inc()
            telemetry.event("serve.auto_refresh_error", model=self.name,
                            error=str(e)[:200])

    def join_refresh(self, timeout: Optional[float] = None) -> None:
        """Wait for a background refresh in flight, if any."""
        t = self._refresh_thread
        if t is not None:
            t.join(timeout)

    def close(self) -> None:
        self.batcher.close()
        self.join_refresh(timeout=30.0)
        if self.runtime is not None:
            self.runtime.ledger_release()


class ModelRegistry:
    """Thread-safe name -> ServingModel map.

    `params` takes the serving knobs (`serve_max_batch_rows`,
    `serve_max_wait_ms`, `serve_queue_depth`, `serve_deadline_ms`,
    `serve_warmup`, `serve_device_sum`, `serve_compiled`,
    `serve_precision`, `serve_quant_bits`, `serve_tile_vmem_kb`,
    `serve_vram_budget_mb`, `serve_auto_refresh`,
    `serve_dispatch_timeout_ms`, `serve_breaker_backoff_s` / `_max_s`,
    the `serve_trace*` recorder knobs, `fault_spec`, `device_type` —
    aliases resolve through utils/config.py like every other param).

    Constructing a registry configures the process-global
    `telemetry.SERVE_RECORDER` from its `serve_trace*` params (the last
    registry constructed wins, which is the one serving)."""

    def __init__(self, params: Optional[dict] = None):
        self._config = Config(dict(params or {}))
        cfg = self._config
        self._lock = make_lock("serving.registry._lock")
        # serializes the budget decision (_admit) WITH the swap it
        # admits: a demotion decided from a pre-swap LRU snapshot could
        # otherwise demote the entry a concurrent load() just made live
        self._swap_lock = make_lock("serving.registry._swap_lock")
        self._models: Dict[str, ServingModel] = {}
        # per-model traffic sampler hooks: each is called with every
        # request's row block, outside the serving data path
        self._samplers: Dict[str, List[object]] = {}
        telemetry.SERVE_RECORDER.configure(
            enabled=cfg.serve_trace, capacity=cfg.serve_trace_ring,
            slow_ms=cfg.serve_trace_slow_ms,
            sample_every=cfg.serve_trace_sample)
        # `fault_spec` arms the process-global fault plane (grammar in
        # resilience/faults.py); $LGBM_FAULTS arms it at import
        if cfg.fault_spec:
            FAULTS.arm(cfg.fault_spec)

    # -------------------------------------------------------------- load
    def load(self, name: str, model: Union[str, object], *,
             warmup: Optional[bool] = None,
             shard_devices: Optional[int] = None) -> ServingModel:
        """Register `model` (a Booster or a model-file path) under
        `name`, warmed up, replacing any previous holder atomically.
        Raises `LightGBMError` without touching the registry when the
        runtime cannot be built (a probe that disagrees, a kernel that
        fails, more shard devices than are visible) or would not fit
        `serve_vram_budget_mb` even after LRU demotion of the other
        entries.

        `shard_devices` (default `serve_shard_devices`) other than 1
        builds a `ShardedServingRuntime`: a replica on each of that many
        devices (0: every visible one), the traffic striped over them."""
        from ..booster import Booster
        booster = model if isinstance(model, Booster) \
            else Booster(model_file=str(model))
        cfg = self._config
        if shard_devices is None:
            shard_devices = int(cfg.serve_shard_devices)
        with _swap_window(), telemetry.span("serve.load", model=name):
            kw = dict(max_batch_rows=cfg.serve_max_batch_rows, name=name,
                      device_sum=cfg.serve_device_sum,
                      compiled=cfg.serve_compiled,
                      precision=cfg.serve_precision,
                      quant_bits=cfg.serve_quant_bits,
                      tile_vmem_kb=cfg.serve_tile_vmem_kb,
                      dispatch_timeout_ms=cfg.serve_dispatch_timeout_ms,
                      breaker_backoff_s=cfg.serve_breaker_backoff_s,
                      breaker_backoff_max_s=cfg.serve_breaker_backoff_max_s)
            if shard_devices != 1:
                runtime = ShardedServingRuntime(
                    booster, shard_devices=shard_devices,
                    device_type=cfg.device_type, **kw)
            else:
                runtime = ServingRuntime(booster, device=cfg.device_type,
                                         **kw)
            # the swap lock spans admit -> swap: the LRU demotion
            # decision and the swap it admits are one atomic step
            with self._swap_lock:
                self._admit(name, runtime)
                if cfg.serve_warmup if warmup is None else warmup:
                    runtime.warmup()
                batcher = MicroBatcher(
                    runtime, max_batch_rows=cfg.serve_max_batch_rows,
                    max_wait_ms=cfg.serve_max_wait_ms,
                    queue_depth=cfg.serve_queue_depth,
                    deadline_ms=cfg.serve_deadline_ms)
                entry = ServingModel(name, runtime, batcher,
                                     auto_refresh=cfg.serve_auto_refresh)
                with self._lock:
                    old = self._models.get(name)
                    self._models[name] = entry
                    telemetry.REGISTRY.gauge("serve.models").set(
                        len(self._models))
        telemetry.REGISTRY.counter("serve.model_loads").inc()
        self._update_vram_gauge()
        if old is not None:
            old.close()
        return entry

    def _admit(self, name: str, runtime: ServingRuntime) -> None:
        """Budget gate for a new export: demote LRU entries until the
        newcomer fits, else reject it — loaded models keep serving
        either way.  Caller holds `_swap_lock`."""
        budget = int(self._config.serve_vram_budget_mb * (1 << 20))
        if budget <= 0:
            return
        # the budget is a device's: a sharded runtime's copies spread over
        # its replicas' devices, so the ceiling scales with them
        budget *= getattr(runtime, "num_replicas", 1)
        need = runtime.device_bytes()
        with self._lock:
            others = [e for n, e in self._models.items() if n != name]
        used = sum(e.runtime.device_bytes() for e in others)
        if used + need > budget:
            for e in sorted(others, key=lambda e: e.last_used):
                if used + need <= budget:
                    break
                freed = e.runtime.demote()
                if freed:
                    telemetry.event("serve.demote", model=e.name,
                                    freed_bytes=freed)
                    used -= freed
        self._update_vram_gauge()
        # the declared ceiling against what the admit measured: a
        # violation here means the demotions did not free what they said
        telemetry.MEMLEDGER.audit(
            "serve_vram_budget_mb", budget, used + need, model=name,
            site="registry.admit", need_bytes=need, used_bytes=used)
        if used + need > budget:
            raise LightGBMError(
                f"serving model {name!r} needs {need} device bytes but "
                f"only {max(budget - used, 0)} of the "
                f"serve_vram_budget_mb={self._config.serve_vram_budget_mb:g}"
                f" budget remain ({used} in use); raise the budget or "
                f"unload a model — already-loaded models keep serving")

    def _update_vram_gauge(self) -> None:
        with self._lock:
            total = sum(e.runtime.device_bytes()
                        for e in self._models.values())
        telemetry.REGISTRY.gauge("serve.vram_bytes").set(total)

    def unload(self, name: str) -> None:
        with self._lock:
            entry = self._models.pop(name, None)
            telemetry.REGISTRY.gauge("serve.models").set(
                len(self._models))
        if entry is not None:
            entry.close()
        self._update_vram_gauge()

    # ------------------------------------------------------------ lookup
    def get(self, name: str = "default") -> ServingModel:
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise LightGBMError(f"no model {name!r} loaded "
                                f"(loaded: {self.names() or 'none'})")
        return entry

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def status(self) -> Dict:
        """Registry health snapshot (the `/healthz` payload body): model
        names, entries whose booster changed since export (`stale`),
        demoted entries, per-entry device bytes, each entry's rung, its
        cause and its breakers' states (`rungs`), each bounded-precision
        entry's contract (`bounded`) and, once any request has
        completed, the all-rung server-side latency percentiles
        (`latency_ms`).  Also refreshes the `serve.stale` gauge."""
        with self._lock:
            entries = dict(sorted(self._models.items()))
        stale = [n for n, e in entries.items() if e.runtime.stale()]
        telemetry.REGISTRY.gauge("serve.stale").set(len(stale))
        out = {"models": list(entries),
               "stale": stale,
               "demoted": [n for n, e in entries.items()
                           if e.runtime.demoted],
               "device_bytes": {n: e.runtime.device_bytes()
                                for n, e in entries.items()},
               "rungs": {}}
        bounded = {}
        for n, e in entries.items():
            rs = e.runtime.status()
            out["rungs"][n] = {"rung": rs["rung"], "cause": rs["cause"],
                               "breakers": rs["breakers"]}
            if "bounded" in rs:
                bounded[n] = rs["bounded"]
        if bounded:
            out["bounded"] = bounded
        lat = telemetry.e2e_latency_summary()
        if lat is not None:
            out["latency_ms"] = lat
        return out

    # --------------------------------------------------- traffic sampling
    def attach_sampler(self, name: str, sampler) -> None:
        """Attach a per-model traffic sampler (any callable taking the
        request's row block).  Several samplers may coexist per model;
        sampling happens before dispatch, and a sampler exception never
        fails a request."""
        with self._lock:
            self._samplers.setdefault(name, []).append(sampler)

    def detach_sampler(self, name: str, sampler=None) -> None:
        """Detach one sampler (by identity) or, with `sampler=None`,
        every sampler registered for the model."""
        with self._lock:
            if sampler is None:
                self._samplers.pop(name, None)
                return
            hooks = self._samplers.get(name)
            if hooks is None:
                return
            self._samplers[name] = [s for s in hooks if s is not sampler]
            if not self._samplers[name]:
                self._samplers.pop(name, None)

    def predict(self, X, model: str = "default", raw_score: bool = False,
                timeout: Optional[float] = None,
                trace: Optional[telemetry.RequestTrace] = None):
        with self._lock:
            samplers = list(self._samplers.get(model, ()))
        for sampler in samplers:
            try:
                sampler(X)
            except Exception:  # sampling is best-effort observability
                telemetry.REGISTRY.counter("serve.sampler_errors").inc()
        for _ in range(_SWAP_RETRIES):
            entry = self.get(model)
            try:
                return entry.predict(X, raw_score=raw_score,
                                     timeout=timeout, trace=trace)
            except ServingClosedError:
                # a hot-swap closed this entry's batcher between the
                # name lookup and the dispatch — the successor entry is
                # already live, so the swap stays invisible to callers.
                # Re-raise when the name is gone or unchanged (a real
                # close, not a swap).
                with self._lock:
                    cur = self._models.get(model)
                if cur is None or cur is entry:
                    raise
        telemetry.REGISTRY.counter("serve.swap_retry_exhausted").inc()
        raise ServingClosedError(
            f"model {model!r} was hot-swapped {_SWAP_RETRIES} times "
            "mid-dispatch; giving up — retry the request")

    # ------------------------------------------------------------- close
    def close(self) -> None:
        with self._lock:
            entries = list(self._models.values())
            self._models.clear()
            telemetry.REGISTRY.gauge("serve.models").set(0)
        for e in entries:
            e.close()
        telemetry.REGISTRY.gauge("serve.vram_bytes").set(0)
