"""Request-scoped serving traces and the tail-sampled flight recorder.

The serving ladder (serving/runtime.py) can say *that* it was slow —
`serve.latency` min/mean/max — but not *where* a given request spent its
time.  This module closes that gap, the serving sibling of the
training flight recorder in `recorder.py`:

  `RequestTrace`  — one per request: an id (honoring an inbound
                    `X-Request-Id`), monotonic stage stamps, and the
                    ladder rung that ultimately served it.
  `StageClock`    — per-group accumulator the runtime fills (staging
                    copy / device dispatch / D2H / convert) while the
                    batcher fills the queue-side stages; deltas land in
                    per-rung `serve.stage.*` histograms.
  `ServeRecorder` — bounded ring of *completed* trace dicts, tail-
                    sampled: every shed / error / host-walk-fallback
                    request, everything slower than `slow_ms`, plus a
                    deterministic 1-in-N of the healthy rest.  Served at
                    `/debug/requests` and by `telemetry-report`.

Stages partition a request's timeline (queue_wait → coalesce →
stage_copy → dispatch → d2h → convert → finish), so their sum tracks the
recorded end-to-end latency to within scheduler noise — the property the
acceptance smoke pins at 5%.  All stamps are host-side `perf_counter`
reads around boundaries the runtime already crosses: tracing adds ZERO
device syncs (on the card the dispatch stage measures enqueue time; the
copy back to the host is the one true sync).

The port's copy of `lightgbm_tpu/telemetry/request_trace.py`, stdlib
only; the training flight recorder it names waits for ROADMAP item 5g.
"""
from __future__ import annotations

import collections
import threading
import time
import uuid
from typing import Any, Deque, Dict, List, Optional, Tuple

from .metrics import REGISTRY, Histogram
from .sinks import make_event
from .spans import TRACER

#: Stage order for display; also the partition of a request's timeline.
STAGES: Tuple[str, ...] = ("queue_wait", "coalesce", "stage_copy",
                           "dispatch", "d2h", "convert", "finish")

#: The ladder rungs a request can be served by (runtime.py).
RUNGS: Tuple[str, ...] = ("device_sum", "slot_path", "host_walk")


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


class StageClock:
    """Per-runtime-call stage accumulator.

    One clock per batch group; the group runs on one batcher worker
    thread, so plain adds need no lock.  `rung` is set by the runtime to
    whichever ladder rung actually produced the bytes.
    """

    __slots__ = ("stages", "rung")

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.rung: Optional[str] = None

    def add(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds


class RequestTrace:
    """One request's journey through the serving stack.

    Created at the frontend (http.py honors an inbound `X-Request-Id`;
    the batcher makes one for in-process callers), stamped by the batcher
    (queue/coalesce/finish) and the runtime (via the group's StageClock),
    finalized exactly once at the request's terminal point — ok, shed,
    or error.
    """

    __slots__ = ("id", "model", "rows", "raw", "t0", "ts", "stages",
                 "rung", "status", "error", "t_dequeued", "t_end")

    def __init__(self, request_id: Optional[str] = None, model: str = "",
                 rows: int = 0, raw: bool = False):
        self.id = request_id or new_request_id()
        self.model = model
        self.rows = int(rows)
        self.raw = bool(raw)
        self.ts = time.time()             # wall clock, for /debug display
        self.t0 = time.perf_counter()     # monotonic origin for stages
        self.t_dequeued = 0.0
        self.t_end = 0.0
        self.stages: Dict[str, float] = {}
        self.rung: Optional[str] = None
        self.status: Optional[str] = None
        self.error: Optional[str] = None

    def add_stage(self, stage: str, seconds: float) -> None:
        if seconds > 0.0:
            self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    def merge_clock(self, clock: StageClock) -> None:
        """Attach the batch group's runtime-side stage deltas.  Shared by
        every request in the group — the batch *is* the unit of device
        work, so per-request attribution of device time is the group's."""
        for stage, s in clock.stages.items():
            self.add_stage(stage, s)
        if clock.rung:
            self.rung = clock.rung

    def finish(self, status: str, error: Optional[str] = None) -> None:
        self.t_end = time.perf_counter()
        self.status = status
        self.error = error

    @property
    def e2e_s(self) -> float:
        return (self.t_end or time.perf_counter()) - self.t0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "id": self.id, "ts": round(self.ts, 6), "model": self.model,
            "rows": self.rows, "raw": self.raw,
            "status": self.status or "open",
            "rung": self.rung or "none",
            "e2e_ms": round(self.e2e_s * 1e3, 3),
            "stages_ms": {s: round(v * 1e3, 3)
                          for s, v in sorted(self.stages.items())},
        }
        if self.error:
            d["error"] = self.error
        return d


class ServeRecorder:
    """Bounded ring of tail-sampled completed request traces.

    Keep rules, in order: every non-ok trace (shed / error / closed),
    every host-walk fallback, everything with e2e above `slow_ms`, and a
    deterministic 1-in-`sample_every` of the healthy remainder so the
    ring always shows what *normal* looks like next to the tail.

    Process-global (`SERVE_RECORDER`), like REGISTRY and TRACER: the
    /debug/requests endpoint and `bench.py --serve` read it without
    plumbing a handle through five layers.  `configure()` is re-entrant —
    the last registry to start wins, which is also the one serving.
    """

    def __init__(self, capacity: int = 256, slow_ms: float = 100.0,
                 sample_every: int = 64, enabled: bool = True):
        self._lock = threading.Lock()
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(1, int(capacity)))
        self.capacity = max(1, int(capacity))
        self.slow_ms = float(slow_ms)
        self.sample_every = max(1, int(sample_every))
        self.enabled = bool(enabled)
        self.seen = 0
        self.recorded = 0

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  slow_ms: Optional[float] = None,
                  sample_every: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if capacity is not None and int(capacity) != self.capacity:
                self.capacity = max(1, int(capacity))
                self._ring = collections.deque(self._ring,
                                               maxlen=self.capacity)
            if slow_ms is not None:
                self.slow_ms = float(slow_ms)
            if sample_every is not None:
                self.sample_every = max(1, int(sample_every))

    def _keep(self, trace: Dict[str, Any], ordinal: int) -> bool:
        if trace.get("status") != "ok":
            return True
        if trace.get("rung") == "host_walk":   # fallback rung: always tail
            return True
        if trace.get("e2e_ms", 0.0) >= self.slow_ms:
            return True
        return ordinal % self.sample_every == 0

    def record(self, trace: RequestTrace) -> bool:
        """Apply the tail-sampling rules to a finalized trace; returns
        whether it entered the ring."""
        if not self.enabled:
            return False
        d = trace.to_dict()
        with self._lock:
            self.seen += 1
            keep = self._keep(d, self.seen)
            if keep:
                self.recorded += 1
                self._ring.append(d)
        REGISTRY.counter("serve.trace.seen").inc()
        if keep:
            REGISTRY.counter("serve.trace.recorded").inc()
            if TRACER._sinks:
                TRACER._emit(make_event("trace", "serve.request", **d))
        return keep

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """JSON body for /debug/requests: newest first."""
        with self._lock:
            traces = list(self._ring)[::-1]
            out = {"enabled": self.enabled, "capacity": self.capacity,
                   "slow_ms": self.slow_ms,
                   "sample_every": self.sample_every,
                   "seen": self.seen, "recorded": self.recorded}
        if limit is not None:
            traces = traces[:max(0, int(limit))]
        out["requests"] = traces
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.seen = 0
            self.recorded = 0


#: The process-global serving recorder (configured by ModelRegistry from
#: the `serve_trace*` params).
SERVE_RECORDER = ServeRecorder()


def observe_stages(trace: RequestTrace) -> None:
    """Fold a finalized trace's stage deltas into the per-rung
    `serve.stage.*` histograms (plus `serve.stage.e2e`).  One call per
    request at its terminal point — the rung is only known then."""
    rung = trace.rung or "none"
    for stage, s in trace.stages.items():
        REGISTRY.histogram(f"serve.stage.{stage}", rung=rung).observe(s)
    REGISTRY.histogram("serve.stage.e2e", rung=rung).observe(trace.e2e_s)


def e2e_latency_summary() -> Optional[Dict[str, Any]]:
    """All-rung merged e2e percentiles (ms) for /healthz, or None before
    any request has completed."""
    fam = REGISTRY.histogram_family("serve.stage.e2e")
    merged = Histogram.merged(fam)
    if not merged.count:
        return None
    pct = merged.percentiles()
    return {"count": merged.count,
            **{p + "_ms": round(v * 1e3, 3) for p, v in pct.items()}}


def server_latency_block() -> Dict[str, Dict[str, Any]]:
    """Per-rung server-side e2e summary for the bench's `serving.server`
    block: {rung: {count, p50_ms, p99_ms}} from the live histograms."""
    out: Dict[str, Dict[str, Any]] = {}
    for h in REGISTRY.histogram_family("serve.stage.e2e"):
        rung = dict(h.labels).get("rung", "none")
        if not h.count:
            continue
        out[rung] = {"count": h.count,
                     "p50_ms": round(h.quantile(0.50) * 1e3, 3),
                     "p99_ms": round(h.quantile(0.99) * 1e3, 3)}
    return out
