"""Process-global metrics registry: counters, gauges, timings, histograms.

The registry is the always-on half of the telemetry layer (the spans in
`spans.py` are the other): incrementing a counter is a dict lookup plus an
integer add under a cheap per-metric lock, cheap enough to leave in
production hot paths (ref: the reference's USE_TIMETAG chrono accumulators
in serial_tree_learner.cpp — ours are always compiled in, never ifdef'd).

The port's copy of `lightgbm_tpu/telemetry/metrics.py`, stdlib only.
"""
from __future__ import annotations

import bisect
import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple


class Counter:
    """Monotonic counter (rounds trained, rows predicted, probe hangs...).

    `inc` takes a per-instance lock: `+=` on a shared int is two bytecodes
    and the serving threads hammer the same counters concurrently, so
    relying on GIL scheduling would lose increments under contention.

    `labels` (sorted `(key, value)` pairs, like `Gauge`/`Histogram`) let
    one counter name carry per-cause series — `serve.host_walk{cause=}` —
    rendered as Prometheus labels on export and as `name{k=v}` keys in
    snapshots.  Label-free counters are unchanged.
    """

    __slots__ = ("name", "value", "labels", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.value = 0
        self.labels = tuple(labels)
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins value (current chunk size, device count...).

    `set` is a single attribute store — atomic under the GIL, no lock
    needed for last-write-wins semantics.

    `labels` (sorted `(key, value)` pairs, like `Histogram`) let one
    metric name carry per-entity series — `fleet.slo.burn_rate{tenant=}`
    / `serve.drift.psi{feature=}` — rendered as Prometheus labels on
    export and as `name{k=v}` keys in snapshots.
    """

    __slots__ = ("name", "value", "labels")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.value = 0.0
        self.labels = tuple(labels)

    def set(self, v: float) -> None:
        self.value = float(v)


class Timing:
    """Timing accumulator: count / total / min / max seconds.

    For quantiles use `Histogram`; min/mean/max covers the per-phase
    attribution the bench and the report CLI need without a bucket-layout
    tuning surface.  `observe` mutates four fields, so it runs under a
    per-instance lock — a torn update would corrupt mean/min/max forever.
    """

    __slots__ = ("name", "count", "total", "min", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        with self._lock:
            self.count += 1
            self.total += s
            if s < self.min:
                self.min = s
            if s > self.max:
                self.max = s

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


def _log_bucket_bounds(lo: float = 1e-6, hi: float = 10.0,
                       per_decade: int = 8) -> Tuple[float, ...]:
    """Log-scaled upper bucket edges spanning [lo, hi] seconds.

    1 µs → 10 s at 8 buckets per decade is 57 finite edges (58 buckets
    with +Inf, under the 64-bucket budget) with ~33% relative resolution
    per bucket — enough for a meaningful p99 at any serving latency from
    sub-millisecond device hits to multi-second host walks.
    """
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


#: Shared bucket layout for every Histogram: quantiles from different
#: instances stay comparable and merged views are an element-wise sum.
HISTOGRAM_BOUNDS: Tuple[float, ...] = _log_bucket_bounds()


class Histogram:
    """Fixed-bucket latency histogram with quantile estimation.

    Log-scaled bounds (`HISTOGRAM_BOUNDS`, µs → 10 s) are shared by every
    instance; `observe` is a bisect plus three adds under a per-instance
    lock.  Quantiles interpolate linearly inside the containing bucket
    (the classic Prometheus `histogram_quantile` estimator), so they are
    exact to one bucket's width (~33% relative) — the right trade for an
    always-on serving metric that must never allocate per observation.

    `labels` (sorted `(key, value)` pairs) render as Prometheus labels on
    the exported `_bucket`/`_sum`/`_count` series, letting per-rung series
    (`serve.stage.e2e{rung="device_sum"}`) share one metric name.
    """

    __slots__ = ("name", "labels", "bounds", "counts", "count", "sum",
                 "max", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = tuple(labels)
        self.bounds = HISTOGRAM_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        i = bisect.bisect_left(self.bounds, s)  # le semantics: v <= edge
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += s
            if s > self.max:
                self.max = s

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) by linear interpolation
        inside the containing bucket; the open +Inf bucket interpolates
        toward the largest value ever observed."""
        with self._lock:
            count = self.count
            counts = list(self.counts)
            vmax = self.max
        if not count:
            return 0.0
        rank = q * count
        cum = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else max(vmax, self.bounds[-1])
                return lo + (hi - lo) * ((rank - cum) / c)
            cum += c
        return vmax

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99), "p999": self.quantile(0.999)}

    def count_over(self, threshold: float) -> int:
        """Observations above `threshold` seconds, at bucket resolution:
        everything in buckets strictly above the bucket containing the
        threshold.  EXACT when the threshold lands on a bucket edge
        (observe uses <=-edge semantics, so bucket i holds values <=
        bounds[i]); otherwise the count excludes the threshold's own
        bucket — a deterministic undercount of at most one bucket's
        population.  This is the SLO error-count primitive: budgets that
        sit on the log ladder (10ms = edge 32) count exactly."""
        i = bisect.bisect_left(self.bounds, float(threshold))
        with self._lock:
            return sum(self.counts[i + 1:])

    @classmethod
    def merged(cls, hists: Iterable["Histogram"],
               name: str = "merged") -> "Histogram":
        """Label-collapsed view: element-wise bucket sum (all instances
        share `HISTOGRAM_BOUNDS`), for e.g. an all-rung e2e p99."""
        out = cls(name)
        for h in hists:
            with h._lock:
                for i, c in enumerate(h.counts):
                    out.counts[i] += c
                out.count += h.count
                out.sum += h.sum
                if h.max > out.max:
                    out.max = h.max
        return out


def _hist_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline must be escaped inside the quoted value (the spec's
    only three escapes).  Label VALUES are user-supplied (tenant names,
    feature names) — interpolating them raw lets one adversarial name
    smuggle extra series or break the exposition parse."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class MetricsRegistry:
    """Thread-safe name -> metric map with snapshot/Prometheus export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._timings: Dict[str, Timing] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        """One counter per (name, label-set); labels become Prometheus
        labels on the exported series and `name{k=v}` snapshot keys
        (`serve.host_walk{cause=device_error}`).  Label-free callers are
        unchanged."""
        lab = tuple(sorted((k, str(v)) for k, v in labels.items()))
        key = _hist_key(name, lab)
        with self._lock:
            m = self._counters.get(key)
            if m is None:
                m = self._counters[key] = Counter(name, lab)
            return m

    def counter_family(self, name: str) -> List[Counter]:
        """Every label variant registered under one counter name."""
        with self._lock:
            return [c for c in self._counters.values() if c.name == name]

    def gauge(self, name: str, **labels: str) -> Gauge:
        """One gauge per (name, label-set); labels become Prometheus
        labels on the exported series and `name{k=v}` snapshot keys
        (`fleet.slo.burn_rate{tenant=gold}`).  Label-free callers are
        unchanged."""
        lab = tuple(sorted((k, str(v)) for k, v in labels.items()))
        key = _hist_key(name, lab)
        with self._lock:
            m = self._gauges.get(key)
            if m is None:
                m = self._gauges[key] = Gauge(name, lab)
            return m

    def gauge_family(self, name: str) -> List[Gauge]:
        """Every label variant registered under one gauge name."""
        with self._lock:
            return [g for g in self._gauges.values() if g.name == name]

    def timing(self, name: str) -> Timing:
        with self._lock:
            m = self._timings.get(name)
            if m is None:
                m = self._timings[name] = Timing(name)
            return m

    def histogram(self, name: str, **labels: str) -> Histogram:
        """One histogram per (name, label-set); labels become Prometheus
        labels on the exported series (`serve.stage.e2e{rung=...}`)."""
        lab = tuple(sorted((k, str(v)) for k, v in labels.items()))
        key = _hist_key(name, lab)
        with self._lock:
            m = self._histograms.get(key)
            if m is None:
                m = self._histograms[key] = Histogram(name, lab)
            return m

    def histogram_family(self, name: str) -> List[Histogram]:
        """Every label variant registered under one metric name."""
        with self._lock:
            return [h for h in self._histograms.values() if h.name == name]

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timings.clear()
            self._histograms.clear()

    def snapshot(self) -> Dict:
        """JSON-serializable dump of everything recorded so far."""
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "timings": {
                    n: {"count": t.count, "total_s": round(t.total, 6),
                        "mean_s": round(t.mean, 6),
                        "min_s": round(t.min, 6) if t.count else 0.0,
                        "max_s": round(t.max, 6)}
                    for n, t in self._timings.items()},
                "histograms": {
                    k: {"count": h.count, "sum_s": round(h.sum, 6),
                        "max_s": round(h.max, 6),
                        **{p + "_s": round(v, 6)
                           for p, v in h.percentiles().items()}}
                    for k, h in self._histograms.items()},
            }

    def to_prometheus(self, prefix: str = "lgbm_tpu") -> str:
        """Prometheus text-exposition dump of the registry.

        Dotted metric names become underscore-separated (`train.rounds`
        -> `lgbm_tpu_train_rounds`); timings expand into the conventional
        `_seconds` summary (`_count`/`_sum`) plus separate
        `_seconds_min`/`_seconds_max` gauges with their own TYPE lines
        (min/max are not valid summary series); histograms export the
        classic cumulative `_bucket{le=...}` series plus `_sum`/`_count`,
        with instance labels merged ahead of `le`.

        Normalization can COLLIDE (`train.rounds` and `train_rounds`
        both map to `lgbm_tpu_train_rounds`, and a counter can shadow a
        gauge): colliding names get a deterministic `_dupN` suffix in
        sorted-iteration order instead of two series silently sharing
        one Prometheus name.
        """
        used: set = set()

        def norm(name: str, suffix: str = "") -> str:
            out = "".join(c if c.isalnum() else "_" for c in name)
            base = f"{prefix}_{out}{suffix}"
            m = base
            dup = 1
            while m in used:
                dup += 1
                m = f"{base}_dup{dup}"
            used.add(m)
            return m

        lines = []
        with self._lock:
            cgroups: Dict[str, List[Counter]] = {}
            for key in sorted(self._counters):
                c = self._counters[key]
                cgroups.setdefault(c.name, []).append(c)
            for n, cs in sorted(cgroups.items()):
                m = norm(n)
                lines.append(f"# TYPE {m} counter")
                for c in cs:
                    lab = ",".join(
                        f'{k}="{_escape_label_value(v)}"'
                        for k, v in c.labels)
                    suf = "{" + lab + "}" if lab else ""
                    lines.append(f"{m}{suf} {c.value}")
            ggroups: Dict[str, List[Gauge]] = {}
            for key in sorted(self._gauges):
                g = self._gauges[key]
                ggroups.setdefault(g.name, []).append(g)
            for n, gs in sorted(ggroups.items()):
                m = norm(n)
                lines.append(f"# TYPE {m} gauge")
                for g in gs:
                    lab = ",".join(
                        f'{k}="{_escape_label_value(v)}"'
                        for k, v in g.labels)
                    suf = "{" + lab + "}" if lab else ""
                    lines.append(f"{m}{suf} {g.value:g}")
            for n, t in sorted(self._timings.items()):
                m = norm(n, "_seconds")
                lines.append(f"# TYPE {m} summary")
                lines.append(f"{m}_count {t.count}")
                lines.append(f"{m}_sum {t.total:.6f}")
                mn = norm(n, "_seconds_min")
                lines.append(f"# TYPE {mn} gauge")
                lines.append(f"{mn} {t.min if t.count else 0.0:.6f}")
                mx = norm(n, "_seconds_max")
                lines.append(f"# TYPE {mx} gauge")
                lines.append(f"{mx} {t.max:.6f}")
            groups: Dict[str, List[Histogram]] = {}
            for key in sorted(self._histograms):
                h = self._histograms[key]
                groups.setdefault(h.name, []).append(h)
            for n, hs in sorted(groups.items()):
                m = norm(n, "_seconds")
                lines.append(f"# TYPE {m} histogram")
                for h in hs:
                    lab = ",".join(
                        f'{k}="{_escape_label_value(v)}"'
                        for k, v in h.labels)
                    pre = lab + "," if lab else ""
                    suf = "{" + lab + "}" if lab else ""
                    with h._lock:
                        counts = list(h.counts)
                        total, cnt = h.sum, h.count
                    cum = 0
                    for i, b in enumerate(h.bounds):
                        cum += counts[i]
                        lines.append(
                            f'{m}_bucket{{{pre}le="{b:.6g}"}} {cum}')
                    cum += counts[-1]
                    lines.append(f'{m}_bucket{{{pre}le="+Inf"}} {cum}')
                    lines.append(f"{m}_sum{suf} {total:.6f}")
                    lines.append(f"{m}_count{suf} {cnt}")
        return "\n".join(lines) + "\n"


#: The process-global registry every instrumented path records into.
REGISTRY = MetricsRegistry()


def write_prometheus(path: str, registry: Optional[MetricsRegistry] = None,
                     prefix: str = "lgbm_tpu") -> None:
    """Write a Prometheus text dump of the registry to `path` (atomic
    enough for a node-exporter textfile collector: write + rename)."""
    reg = registry if registry is not None else REGISTRY
    tmp = f"{path}.tmp.{int(time.time() * 1e6)}"
    with open(tmp, "w") as f:
        f.write(reg.to_prometheus(prefix))
    os.replace(tmp, path)
