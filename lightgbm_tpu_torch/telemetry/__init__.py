"""Telemetry that the serving plane reads (the port's part of
`lightgbm_tpu/telemetry/`):

 - `REGISTRY` — process-global counters / gauges / timings / histograms
   with JSON snapshot and the Prometheus text of `/metrics`
   (metrics.py);
 - `TRACER` / `span()` / `event()` — named, nested wall-clock phases
   mirrored into `torch.profiler.record_function` (spans.py), written
   to the sinks of sinks.py;
 - `StageClock`, `RequestTrace`, `SERVE_RECORDER`, `observe_stages` —
   request-scoped serving traces and the tail-sampled ring of
   `/debug/requests` (request_trace.py);
 - `MEMLEDGER` — the attributed device-memory ledger of
   `/debug/memory` (memledger.py).

The rest of the JAX package's telemetry (spool, lineage ledger, SLO
meter, snapshot diff, report and flight recorder, `fleet_snapshot`, the
memory CLI) waits for ROADMAP Queue 1 item 5g.  Stdlib only.
"""
from .memledger import MEMLEDGER, MemoryLedger, is_oom, render_memory
from .metrics import (HISTOGRAM_BOUNDS, Counter, Gauge, Histogram,
                      MetricsRegistry, REGISTRY, Timing, write_prometheus)
from .request_trace import (RequestTrace, SERVE_RECORDER, ServeRecorder,
                            StageClock, e2e_latency_summary, new_request_id,
                            observe_stages, server_latency_block)
from .sinks import (JsonlSink, MemorySink, Sink, iso_ts, make_event,
                    read_jsonl, read_jsonl_counted)
from .spans import NOOP, Span, TRACER, Tracer, event, span

__all__ = [
    "MEMLEDGER", "MemoryLedger", "is_oom", "render_memory",
    "Counter", "Gauge", "Histogram", "HISTOGRAM_BOUNDS", "MetricsRegistry",
    "REGISTRY", "Timing", "write_prometheus",
    "JsonlSink", "MemorySink", "Sink", "iso_ts", "make_event", "read_jsonl",
    "read_jsonl_counted",
    "NOOP", "Span", "TRACER", "Tracer", "event", "span",
    "RequestTrace", "SERVE_RECORDER", "ServeRecorder", "StageClock",
    "e2e_latency_summary", "new_request_id", "observe_stages",
    "server_latency_block",
]
