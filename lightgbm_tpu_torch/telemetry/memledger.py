"""The attributed device-memory ledger: who owns each resident byte.

The port's counterpart of `lightgbm_tpu/telemetry/memledger.py`
(`is_oom` `:101`, `MemHandle` `:145`, `LeakSentinel` `:181`,
`MemoryLedger` `:240`, `render_memory` `:759`).  Subsystems that put
bytes on a device register the tensor under an owner tag
(`train.bins`, `train.scores`, `train.hist_carry`,
`serve.<model>.planes{rung=}`, `serve.<model>.staging`,
`stream.staging`, `compile.plan`) with `MEMLEDGER.register(owner,
tensor)`:

 - a handle charges its tensor's storage (`untyped_storage().nbytes()`)
   and is keyed on the storage's pointer, so a view of a storage that is
   registered already adds nothing; it holds a weakref to the tensor, so
   a free is seen without an explicit release.  Registering reads
   metadata only and never syncs the device.  Gauges: `mem.<dev>.<owner>`
   live bytes and `.peak_bytes`, `mem.<dev>.attributed_bytes`;
 - `reconcile()` holds the attributed totals against the allocator: on
   a CUDA device `torch.cuda.memory_stats(device)
   ["allocated_bytes.all.current"]` (`source: "memory_stats"`); without
   an initialised CUDA device there is no allocator to ask and the
   source is "none", as the reference's without a backend;
 - `audit(contract, budget, measured)` counts
   `mem.budget_violation{contract=}` when a declared ceiling is broken;
   it never raises;
 - the leak sentinel fits a Theil-Sen slope (median of pairwise slopes)
   to the per-round watermarks, `mem.leak.slope_mb_per_min`;
 - `oom_guard(site)` wraps dispatch sites: an out-of-memory error
   (`torch.cuda.OutOfMemoryError`, "CUDA out of memory") leaving the body
   emits the attributed snapshot as an `{"ev": "oom"}` event, then
   re-raises unchanged.

`GET /debug/memory` (serving/http.py) returns `debug_snapshot()`.
Models and scores are the same bytes with the ledger on or off: it
observes allocations and never changes them.  Stdlib only: torch is read
from `sys.modules`, never imported.
"""
from __future__ import annotations

import collections
import sys
import threading
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..utils.locks import make_lock
from .metrics import REGISTRY
from .sinks import make_event
from .spans import TRACER

#: fingerprints reported for the largest tensors a reconcile cannot
#: attribute (none on torch: its allocator lists no tensors)
MAX_UNKNOWN_FINGERPRINTS = 5

#: the leak sentinel's ring (observations) and the pairs its fit keeps
SENTINEL_CAPACITY = 512
SENTINEL_MAX_PAIRS = 2048


def is_oom(exc: BaseException) -> bool:
    """Whether an exception is device-memory exhaustion: torch's
    `OutOfMemoryError` and its "CUDA out of memory" text, the XLA status
    text RESOURCE_EXHAUSTED, or "out of memory" in any case; an injected
    fault carrying either text stands for the real thing."""
    s = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in s or "OutOfMemory" in s
            or "out of memory" in s.lower())


def _owner_key(owner: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return owner
    return owner + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _tensor_parts(t: Any):
    """(device key, storage key or None, bytes, shape, dtype) of a tensor
    or array, from metadata only: a torch tensor charges its storage to
    `dev<index>` (a CUDA device) or `host`; anything else its `nbytes`
    to `host`."""
    shape = tuple(int(s) for s in (getattr(t, "shape", ()) or ()))
    dtype = str(getattr(t, "dtype", "?"))
    storage = getattr(t, "untyped_storage", None)
    if callable(storage):
        st = storage()
        d = t.device
        dev = f"dev{d.index or 0}" if d.type == "cuda" else "host"
        return dev, (dev, st.data_ptr()), int(st.nbytes()), shape, dtype
    return "host", None, int(getattr(t, "nbytes", 0)), shape, dtype


class MemHandle:
    """One registered buffer: its owner, labels, device, bytes, and the
    weakref whose death reports the free.  `release()` is explicit and
    idempotent."""

    __slots__ = ("owner", "labels", "device", "key", "nbytes", "shape",
                 "dtype", "released", "_ledger", "_ref", "__weakref__")

    def __init__(self, ledger: Optional["MemoryLedger"], owner: str,
                 labels: Tuple[Tuple[str, str], ...], device: str, key,
                 nbytes: int, shape: Tuple[int, ...], dtype: str):
        self.owner = owner
        self.labels = labels
        self.device = device
        self.key = key
        self.nbytes = nbytes
        self.shape = shape
        self.dtype = dtype
        self.released = False          # guarded-by: the ledger's _lock
        self._ledger = ledger
        self._ref: Optional[weakref.ref] = None

    def release(self) -> None:
        if self._ledger is not None:
            self._ledger.release(self)


#: what a disabled ledger hands out: held and released like any handle
_NOOP_HANDLE = MemHandle(None, "", (), "host", None, 0, (), "?")


class LeakSentinel:
    """A bounded (t, bytes) series of watermarks and its Theil-Sen slope:
    the median of the pairwise slopes, which an allocator's sawtooth
    around a flat baseline leaves near zero and a steady leak pulls
    positive.  Times can be given (tests); else the monotonic clock."""

    def __init__(self, capacity: int = SENTINEL_CAPACITY):
        self._lock = make_lock("telemetry.memledger.sentinel._lock")
        self._pts: collections.deque = collections.deque(
            maxlen=max(int(capacity), 4))  # guarded-by: _lock

    def observe(self, nbytes: float, t: Optional[float] = None) -> float:
        """Add one watermark and publish the slope gauge; returns the
        slope in MB a minute."""
        ts = time.monotonic() if t is None else float(t)
        with self._lock:
            self._pts.append((ts, float(nbytes)))
        slope = self.slope_mb_per_min()
        REGISTRY.gauge("mem.leak.slope_mb_per_min").set(round(slope, 6))
        return slope

    def slope_mb_per_min(self) -> float:
        with self._lock:
            pts = list(self._pts)
        n = len(pts)
        if n < 3 or pts[-1][0] <= pts[0][0]:
            return 0.0
        # a stride on the first index keeps the pair count bounded
        stride = 1
        while (n // stride) * (n - 1) // 2 > SENTINEL_MAX_PAIRS:
            stride += 1
        slopes: List[float] = []
        for i in range(0, n - 1, stride):
            t0, b0 = pts[i]
            for j in range(i + 1, n):
                dt = pts[j][0] - t0
                if dt > 0:
                    slopes.append((pts[j][1] - b0) / dt)
        if not slopes:
            return 0.0
        slopes.sort()
        mid = len(slopes) // 2
        med = slopes[mid] if len(slopes) % 2 else \
            0.5 * (slopes[mid - 1] + slopes[mid])
        return med * 60.0 / float(1 << 20)          # bytes/s -> MB/min

    def samples(self) -> int:
        with self._lock:
            return len(self._pts)

    def reset(self) -> None:
        with self._lock:
            self._pts.clear()


class MemoryLedger:
    """The process-global ledger of attributed device bytes, per device
    and owner.  One lock guards the tables; weakref callbacks, which run
    wherever the collector does (possibly with the lock held), only park
    the dead handle on a deque that every entry point drains under the
    lock."""

    def __init__(self):
        self._lock = make_lock("telemetry.memledger._lock")
        #: (device, owner key) -> [live bytes, peak bytes]
        self._slots: Dict[Tuple[str, str], List[int]] = {}  # guarded-by: _lock
        self._handles: set = set()                 # guarded-by: _lock
        self._by_key: Dict[Any, MemHandle] = {}    # guarded-by: _lock
        self._dev_live: Dict[str, int] = {}        # guarded-by: _lock
        self._dev_peak: Dict[str, int] = {}        # guarded-by: _lock
        self._pending: collections.deque = collections.deque()
        self._enabled = True
        self._sentinel = LeakSentinel()
        self._reconcile_stop = threading.Event()
        self._reconcile_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------ configuration
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def sentinel(self) -> LeakSentinel:
        return self._sentinel

    def configure(self, enabled: bool = True,
                  reconcile_ms: float = 0.0) -> None:
        """Arm or disarm the ledger (`memory_ledger`) and, with
        `memory_reconcile_ms` > 0, start the background reconciler (off
        the training and request threads)."""
        self._enabled = bool(enabled)
        period_s = max(float(reconcile_ms or 0.0), 0.0) / 1000.0
        with self._lock:
            th = self._reconcile_thread
            if self._enabled and period_s > 0.0 and \
                    (th is None or not th.is_alive()):
                self._reconcile_stop = threading.Event()
                th = threading.Thread(
                    target=self._reconcile_loop,
                    args=(self._reconcile_stop, period_s),
                    name="memledger-reconcile", daemon=True)
                self._reconcile_thread = th
                th.start()
            elif not self._enabled or period_s <= 0.0:
                self._reconcile_stop.set()

    def _reconcile_loop(self, stop: threading.Event,
                        period_s: float) -> None:
        while not stop.wait(period_s):
            try:
                self.reconcile()
            except Exception:
                REGISTRY.counter("mem.reconcile.errors").inc()

    # -------------------------------------------------------- registration
    def register(self, owner: str, array: Any = None, *,
                 nbytes: Optional[int] = None, device: Optional[str] = None,
                 shape: Optional[Tuple[int, ...]] = None, dtype: str = "?",
                 **labels: str) -> MemHandle:
        """Attribute one tensor to `owner` (labels become gauge labels,
        e.g. `rung="stacked"`), or, without a tensor, `nbytes` on
        `device`.  A tensor whose storage is registered already returns
        that handle and adds nothing.  Metadata only; a no-op handle
        when the ledger is disabled."""
        if not self._enabled:
            return _NOOP_HANDLE
        lab = tuple(sorted((k, str(v)) for k, v in labels.items()))
        if array is not None:
            dev, key, nb, shp, dt = _tensor_parts(array)
        else:
            dev, key, nb = device or "host", None, int(nbytes or 0)
            shp, dt = tuple(shape or ()), str(dtype)
        with self._lock:
            self._drain_locked()
            if key is not None and key in self._by_key:
                return self._by_key[key]
            h = MemHandle(self, owner, lab, dev, key, nb, shp, dt)
            if array is not None:
                try:
                    h._ref = weakref.ref(
                        array,
                        lambda _r, _h=h, _q=self._pending: _q.append(_h))
                except TypeError:
                    h._ref = None           # explicit release only
            self._add_locked(h)
        return h

    def assign(self, owner: str, arrays: Iterable[Any],
               **labels: str) -> List[MemHandle]:
        """Replace every handle registered under exactly (owner, labels)
        with the given tensors: the per-round refresh of buffers that are
        rebound rather than freed (scores, carries)."""
        if not self._enabled:
            return []
        lab = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            self._drain_locked()
            for h in [h for h in self._handles
                      if h.owner == owner and h.labels == lab]:
                self._release_locked(h)
        return [self.register(owner, a, **labels)
                for a in arrays if a is not None]

    def release(self, handle: MemHandle) -> None:
        """Un-attribute a handle (idempotent, also after its weakref
        reported the free)."""
        if handle is _NOOP_HANDLE or handle._ledger is not self:
            return
        with self._lock:
            self._drain_locked()
            self._release_locked(handle)

    def release_owner(self, prefix: str) -> int:
        """Release every handle whose owner starts with `prefix`; returns
        how many."""
        with self._lock:
            self._drain_locked()
            victims = [h for h in self._handles
                       if h.owner.startswith(prefix)]
            for h in victims:
                self._release_locked(h)
        return len(victims)

    # ----------------------------------------------- internals (locked)
    def _drain_locked(self) -> None:
        while True:
            try:
                h = self._pending.popleft()
            except IndexError:
                break
            self._release_locked(h)

    def _add_locked(self, h: MemHandle) -> None:
        self._handles.add(h)
        if h.key is not None:
            self._by_key[h.key] = h
        dev, nb = h.device, h.nbytes
        slot = self._slots.setdefault((dev, _owner_key(h.owner, h.labels)),
                                      [0, 0])
        slot[0] += nb
        slot[1] = max(slot[1], slot[0])
        live = self._dev_live.get(dev, 0) + nb
        self._dev_live[dev] = live
        if live > self._dev_peak.get(dev, 0):
            self._dev_peak[dev] = live
            REGISTRY.gauge(f"mem.{dev}.attributed_peak_bytes").set(live)
        self._publish(h, slot)
        REGISTRY.gauge(f"mem.{dev}.attributed_bytes").set(live)

    def _release_locked(self, h: MemHandle) -> None:
        if h.released:
            return
        h.released = True
        self._handles.discard(h)
        if h.key is not None and self._by_key.get(h.key) is h:
            del self._by_key[h.key]
        slot = self._slots.get((h.device, _owner_key(h.owner, h.labels)))
        if slot is not None:
            slot[0] = max(slot[0] - h.nbytes, 0)
            self._publish(h, slot)
        live = max(self._dev_live.get(h.device, 0) - h.nbytes, 0)
        self._dev_live[h.device] = live
        REGISTRY.gauge(f"mem.{h.device}.attributed_bytes").set(live)

    @staticmethod
    def _publish(h: MemHandle, slot: List[int]) -> None:
        labels = dict(h.labels)
        REGISTRY.gauge(f"mem.{h.device}.{h.owner}", **labels).set(slot[0])
        REGISTRY.gauge(f"mem.{h.device}.{h.owner}.peak_bytes",
                       **labels).set(slot[1])

    # ------------------------------------------------------------ queries
    def attributed_bytes(self, prefix: str = "",
                         device: Optional[str] = None) -> int:
        """Live attributed bytes, of the owners starting with `prefix`
        and on `device` (`dev0`, `host`) when given."""
        with self._lock:
            self._drain_locked()
            return sum(slot[0] for (dev, okey), slot in self._slots.items()
                       if (device is None or dev == device)
                       and okey.startswith(prefix))

    def snapshot(self) -> Dict[str, Any]:
        """Per device and owner, live and peak bytes, the devices' totals,
        the leak sentinel, the budget violations and OOM dumps."""
        with self._lock:
            self._drain_locked()
            devices: Dict[str, Any] = {}
            for (dev, okey), slot in sorted(self._slots.items()):
                d = devices.setdefault(
                    dev, {"owners": {}, "attributed_bytes": 0,
                          "peak_bytes": int(self._dev_peak.get(dev, 0))})
                d["owners"][okey] = {"bytes": int(slot[0]),
                                     "peak_bytes": int(slot[1])}
                d["attributed_bytes"] += int(slot[0])
            handles = len(self._handles)
        violations = {
            ",".join(f"{k}={v}" for k, v in c.labels) or "total": c.value
            for c in REGISTRY.counter_family("mem.budget_violation")}
        return {
            "enabled": self._enabled, "devices": devices,
            "handles": handles,
            "leak": {"slope_mb_per_min": round(
                self._sentinel.slope_mb_per_min(), 6),
                "samples": self._sentinel.samples()},
            "budget_violations": violations,
            "oom_dumps": REGISTRY.counter("mem.oom.dumps").value,
        }

    # --------------------------------------------------------- reconcile
    def reconcile(self, max_fingerprints: int = MAX_UNKNOWN_FINGERPRINTS
                  ) -> Dict[str, Any]:
        """The attributed totals against the allocator's: on each CUDA
        device `torch.cuda.memory_stats(device)
        ["allocated_bytes.all.current"]`; the bytes the ledger cannot
        attribute go to `mem.unattributed_bytes`.  Without an initialised
        CUDA device, `source: "none"` and no devices.  Off the hot path
        (the background thread, a debug GET)."""
        t0 = time.perf_counter()
        out: Dict[str, Any] = {"source": "none", "devices": {},
                               "unattributed_bytes": 0,
                               "largest_unknown": []}
        del max_fingerprints      # torch's allocator names no tensors
        torch = sys.modules.get("torch")
        attributed = {dev: d["attributed_bytes"]
                      for dev, d in self.snapshot()["devices"].items()}
        try:
            live = torch is not None and torch.cuda.is_available() and \
                torch.cuda.is_initialized()
        except Exception:
            live = False
        if not live:
            return out
        truth = {}
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            truth[f"dev{i}"] = int(ms.get("allocated_bytes.all.current", 0))
        total = 0
        for dev in sorted(set(truth) | (set(attributed) - {"host"})):
            t = int(truth.get(dev, 0))
            att = int(attributed.get(dev, 0))
            total += max(t - att, 0)
            out["devices"][dev] = {
                "allocator_bytes": t, "attributed_bytes": att,
                "unattributed_bytes": max(t - att, 0),
                # attributed but not allocated (a handle outliving its
                # free): the opposite miss, kept apart
                "over_attributed_bytes": max(att - t, 0)}
        out["source"] = "memory_stats"
        out["unattributed_bytes"] = total
        REGISTRY.gauge("mem.unattributed_bytes").set(total)
        REGISTRY.timing("mem.reconcile").observe(time.perf_counter() - t0)
        return out

    # ------------------------------------------------------------- audit
    def audit(self, contract: str, budget_bytes: float,
              measured_bytes: float, model: str = "default",
              **evidence: Any) -> bool:
        """Whether `measured_bytes` broke the declared `budget_bytes`
        ceiling of `contract`; a violation counts
        `mem.budget_violation{contract=}` and is emitted as an event with
        its evidence.  Never raises: the sites that enforce a budget keep
        their own refusals."""
        if not self._enabled or budget_bytes <= 0 or \
                measured_bytes <= budget_bytes:
            return False
        REGISTRY.counter("mem.budget_violation", contract=contract).inc()
        if TRACER._sinks:
            TRACER._emit(make_event(
                "event", "memory.budget_violation", model=model,
                contract=contract, budget_bytes=int(budget_bytes),
                measured_bytes=int(measured_bytes), **evidence))
        return True

    # ------------------------------------------------------ round hooks
    def on_round(self, t: Optional[float] = None) -> None:
        """A round's (or poll's) boundary: the attributed watermark to
        the leak sentinel, and with sinks attached a `{"ev": "metrics"}`
        point of the owners' bytes.  Host arithmetic only."""
        if not self._enabled:
            return
        gauges: Dict[str, float] = {}
        total = 0
        with self._lock:
            self._drain_locked()
            for (dev, okey), slot in self._slots.items():
                gauges[f"mem.{dev}.{okey}"] = float(slot[0])
                total += slot[0]
        self._sentinel.observe(total, t=t)
        if TRACER._sinks and gauges:
            TRACER._emit(make_event("metrics", "memory",
                                    snapshot={"gauges": gauges}))

    # ---------------------------------------------------- OOM forensics
    def oom_guard(self, site: str, model: str = "default") -> "_OomGuard":
        """A context manager for dispatch sites: an out-of-memory error
        leaving the body records the snapshot (`record_oom`), then goes
        on unchanged."""
        return _OomGuard(self, site, model)

    def record_oom(self, site: str, exc: BaseException,
                   model: str = "default") -> Dict[str, Any]:
        """The OOM dump: each device's owners' bytes (the snapshot's), the
        top owners across devices and the failing site and error, emitted
        as an `{"ev": "oom"}` event; counts `mem.oom.dumps`."""
        snap = self.snapshot()
        devices: Dict[str, Any] = {}
        ranked: List[Tuple[int, str]] = []
        for dev, d in snap["devices"].items():
            owners = {k: v["bytes"] for k, v in d["owners"].items()}
            devices[dev] = {"owners": owners,
                            "attributed_bytes": d["attributed_bytes"]}
            ranked.extend((b, f"{dev}:{k}") for k, b in owners.items())
        ranked.sort(key=lambda kv: (-kv[0], kv[1]))
        rec = make_event(
            "oom", site, model=model, error=str(exc)[:300], devices=devices,
            attributed_bytes=sum(d["attributed_bytes"]
                                 for d in devices.values()),
            top_owners=[{"owner": o, "bytes": b} for b, o in ranked[:8]])
        REGISTRY.counter("mem.oom.dumps").inc()
        if TRACER._sinks:
            TRACER._emit(rec)
        return rec

    # ------------------------------------------------------------ debug
    def debug_snapshot(self, reconcile: bool = True) -> Dict[str, Any]:
        """The body of `GET /debug/memory`: the snapshot and, by default,
        a fresh reconcile."""
        out = self.snapshot()
        if reconcile:
            out["reconcile"] = self.reconcile()
        return out

    def reset(self) -> None:
        """Drop every handle, slot, peak and sentinel point (tests; the
        REGISTRY gauges are reset apart)."""
        with self._lock:
            self._drain_locked()
            for h in list(self._handles):
                h.released = True
            self._handles.clear()
            self._by_key.clear()
            self._slots.clear()
            self._dev_live.clear()
            self._dev_peak.clear()
            self._pending.clear()
        self._sentinel.reset()


class _OomGuard:
    """The `with` shim of `oom_guard`: two attribute stores when nothing
    raises."""

    __slots__ = ("_ledger", "_site", "_model")

    def __init__(self, ledger: MemoryLedger, site: str, model: str):
        self._ledger = ledger
        self._site = site
        self._model = model

    def __enter__(self) -> "_OomGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None and self._ledger._enabled and is_oom(exc):
            try:
                self._ledger.record_oom(self._site, exc, model=self._model)
            except Exception:
                pass            # the dump never hides the error itself
        return False


#: the process-global ledger every registered allocation reports to
MEMLEDGER = MemoryLedger()


def _fmt_mb(b: float) -> str:
    return f"{b / float(1 << 20):.2f} MB"


def render_memory(snap: Dict[str, Any]) -> str:
    """Fixed-width text of a `/debug/memory` body."""
    lines = ["memory ledger"
             + ("" if snap.get("enabled", True) else " (DISABLED)")]
    rec = snap.get("reconcile") or {}
    rec_devs = rec.get("devices", {})
    for dev, d in sorted(snap.get("devices", {}).items()):
        extra = ""
        rd = rec_devs.get(dev)
        if rd:
            extra = (f", allocator {_fmt_mb(rd['allocator_bytes'])}, "
                     f"unattributed {_fmt_mb(rd['unattributed_bytes'])}")
        lines.append(f"  {dev}: attributed "
                     f"{_fmt_mb(d.get('attributed_bytes', 0))} "
                     f"(peak {_fmt_mb(d.get('peak_bytes', 0))})" + extra)
        for okey, o in sorted(d.get("owners", {}).items(),
                              key=lambda kv: -kv[1]["bytes"]):
            lines.append(f"    {okey:<40} {_fmt_mb(o['bytes']):>12} "
                         f"(peak {_fmt_mb(o['peak_bytes'])})")
    if rec:
        lines.append(f"  reconcile[{rec.get('source', '?')}]: unattributed "
                     f"{_fmt_mb(rec.get('unattributed_bytes', 0))}")
        for u in rec.get("largest_unknown", []):
            lines.append(f"    unknown {u['dtype']}{u['shape']} "
                         f"{_fmt_mb(u['nbytes'])} on {u['device']}")
    leak = snap.get("leak", {})
    if leak:
        lines.append(f"  leak slope: "
                     f"{leak.get('slope_mb_per_min', 0.0):+.4f} MB/min "
                     f"({leak.get('samples', 0)} samples)")
    viol = snap.get("budget_violations", {})
    lines.append("  budget violations: " + (
        ", ".join(f"{k} x{int(v)}" for k, v in sorted(viol.items()))
        if viol else "none"))
    lines.append(f"  oom dumps: {int(snap.get('oom_dumps', 0))}")
    return "\n".join(lines)
