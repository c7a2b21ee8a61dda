"""Spans + Tracer: named, nested wall-clock phases.

`tracer.span("train.chunk", rounds=16)` is a context manager that records
a wall-clock interval, maintains per-thread nesting (depth + parent name),
and on exit emits one `{"ev": "span", ...}` event to every attached sink
and one observation into the timing registry (`span.<name>`).

Two cost regimes, chosen per `span()` call:

 - **inactive** (no sink attached, not force-enabled): `span()` returns a
   shared no-op context manager — one attribute check, zero allocation —
   so the instrumentation stays compiled into production hot paths
   (booster/engine/parallel/ops) at negligible cost.
 - **active**: wall time via `perf_counter`, and the body additionally
   runs under `torch.profiler.record_function(name)` when torch is
   already loaded, so the host-side record and a `torch.profiler` trace
   carry the SAME phase names and can be cross-read (the JAX package
   mirrors into `jax.profiler.TraceAnnotation` at this point).

torch is mirrored via `sys.modules.get("torch")`, never imported here.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from .metrics import REGISTRY
from .sinks import JsonlSink, Sink, make_event


class _NoopSpan:
    """Reusable do-nothing context manager (the inactive fast path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


#: Shared do-nothing span — also handed out directly by call sites that
#: want a span only under some condition (`span(n) if cond else NOOP`).
NOOP = _NOOP = _NoopSpan()


class Span:
    """One named wall-clock phase; records itself on exit."""

    __slots__ = ("tracer", "name", "attrs", "t0", "wall0", "depth",
                 "parent", "_annot")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self._annot = None

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self.parent = stack[-1].name if stack else None
        self.depth = len(stack)
        stack.append(self)
        torch = sys.modules.get("torch")
        if torch is not None:
            try:
                self._annot = torch.profiler.record_function(self.name)
                self._annot.__enter__()
            except Exception:
                self._annot = None
        self.wall0 = time.time()
        self.t0 = time.perf_counter()
        return self

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (e.g. row counts known
        only after construction); emitted with the exit event."""
        self.attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self.t0
        if self._annot is not None:
            try:
                self._annot.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:       # unbalanced exit (generator teardown)
            stack.remove(self)
        REGISTRY.timing(f"span.{self.name}").observe(dur)
        ev = make_event("span", self.name, dur_s=round(dur, 6),
                        depth=self.depth, pid=os.getpid())
        ev["ts"] = round(self.wall0, 6)  # span events stamp their START
        if self.parent is not None:
            ev["parent"] = self.parent
        if self.attrs:
            ev["attrs"] = self.attrs
        if exc_type is not None:
            ev["error"] = getattr(exc_type, "__name__", str(exc_type))
        self.tracer._emit(ev)
        return False


class Tracer:
    """Process-global span recorder with pluggable sinks."""

    def __init__(self):
        self._sinks: List[Sink] = []
        self._jsonl_paths: Dict[str, JsonlSink] = {}
        self._tls = threading.local()
        self._forced = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------- sinks
    @property
    def active(self) -> bool:
        return bool(self._sinks) or self._forced

    def enable(self, flag: bool = True) -> None:
        """Force span recording (into the metrics registry) even with no
        sink attached — for in-process inspection via REGISTRY."""
        self._forced = bool(flag)

    def add_sink(self, sink: Sink) -> Sink:
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)
        return sink

    def remove_sink(self, sink: Sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
            for p, s in list(self._jsonl_paths.items()):
                if s is sink:
                    del self._jsonl_paths[p]
        sink.close()

    def attach_jsonl(self, path: str) -> JsonlSink:
        """Attach (or reuse) a JSONL file sink — idempotent per abspath,
        so every Booster constructed with the same `telemetry_sink` param
        shares one appender instead of stacking duplicates."""
        key = os.path.abspath(path)
        with self._lock:
            sink = self._jsonl_paths.get(key)
            if sink is None:
                sink = JsonlSink(key)
                self._jsonl_paths[key] = sink
                self._sinks.append(sink)
        return sink

    def clear_sinks(self) -> None:
        with self._lock:
            sinks, self._sinks = self._sinks, []
            self._jsonl_paths.clear()
        for s in sinks:
            s.close()

    def flush(self) -> None:
        for s in list(self._sinks):
            s.flush()

    # ------------------------------------------------------------- spans
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, **attrs: Any):
        """Context manager for a named phase; no-op when inactive."""
        if not self.active:
            return _NOOP
        return Span(self, name, attrs)

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    # ------------------------------------------------------------ events
    def _emit(self, event: Dict[str, Any]) -> None:
        for s in list(self._sinks):
            try:
                s.emit(event)
            except Exception:
                # a dead sink (full disk, closed stream) must never take
                # down training — drop the event, keep the run alive
                pass

    def event(self, name: str, **fields: Any) -> Dict[str, Any]:
        """Emit a point event (probe attempt, fallback, ...).  Always
        counts into the registry (`event.<name>`); reaches sinks only
        when one is attached."""
        REGISTRY.counter(f"event.{name}").inc()
        ev = make_event("event", name, **fields)
        if self._sinks:
            self._emit(ev)
        return ev

    def emit_metrics_snapshot(self) -> None:
        """Write the current registry state to the sinks as one event —
        callers (engine.train end, bench worker exit) use it so a JSONL
        file is self-contained for `telemetry-report`."""
        if not self._sinks:
            return
        self._emit(make_event("metrics", "registry",
                              **{"snapshot": REGISTRY.snapshot()}))


#: The process-global tracer every instrumented path records into.
TRACER = Tracer()


def span(name: str, **attrs: Any):
    return TRACER.span(name, **attrs)


def event(name: str, **fields: Any) -> Dict[str, Any]:
    return TRACER.event(name, **fields)
