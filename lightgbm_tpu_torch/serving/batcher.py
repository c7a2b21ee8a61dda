"""Dynamic micro-batcher: bounded queue, rows/deadline flush, shedding.

Concurrent callers submit requests into a bounded queue; one worker
thread coalesces them into batches — flushing when the open batch
reaches `max_batch_rows` or has waited `max_wait_ms` — and runs each
batch through the `ServingRuntime` once.  Under overload the batcher
sheds instead of queueing unboundedly: a full queue rejects at submit
time, and requests whose deadline passed while queued are dropped at
flush time (both raise `ServingOverloadError`, both counted under
`serve.shed` plus a per-cause counter — `serve.shed.queue_full` vs
`serve.shed.deadline` — so overload causes are distinguishable at the
metrics level; sheds landing while a registry hot-swap is building are
additionally counted under `serve.shed.swap_window`, separating
swap-cost sheds from pure load sheds).  A device failure inside the
runtime raises `ServingDeviceError` (its rung's breaker opens) and an
open breaker `ServingUnavailableError`; the batcher hands the error to
every request of the group, as it does any error of the runtime.

Batches coalesce only compatible requests (same raw/prob flavor, same
feature width); a flush holding both flavors simply runs the runtime
once per group.

The port's copy of `lightgbm_tpu/serving/batcher.py`.

Tracing: every request carries a `telemetry.RequestTrace` —
the HTTP frontend passes one in (honoring `X-Request-Id`), in-process
callers get one made here.  The batcher stamps the queue-side stages
(queue_wait / coalesce / finish), the runtime's `StageClock` supplies
the device-side ones, and at each request's terminal point the deltas
land in the per-rung `serve.stage.*` histograms and the trace goes to
the tail-sampled `SERVE_RECORDER` ring (`/debug/requests`).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from .. import telemetry
from ..resilience import FAULTS
from ..utils.log import LightGBMError


class ServingOverloadError(LightGBMError):
    """Request shed: queue full at submit, or deadline passed in queue."""


class ServingClosedError(LightGBMError):
    """The batcher was closed while the request was queued."""


class _Request:
    __slots__ = ("X", "raw", "n", "enqueued", "deadline", "done",
                 "result", "error", "trace", "t_submit", "t_dequeued")

    def __init__(self, X: np.ndarray, raw: bool,
                 deadline: Optional[float],
                 trace: Optional[telemetry.RequestTrace] = None):
        self.X = X
        self.raw = raw
        self.n = X.shape[0]
        self.enqueued = time.monotonic()
        self.deadline = deadline        # absolute monotonic time, or None
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.trace = trace
        self.t_submit = time.perf_counter()   # queue_wait stage origin
        self.t_dequeued = 0.0

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise ServingOverloadError("serving request timed out waiting "
                                       "for a batch slot")
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Coalesces concurrent predict calls into bucket-padded batches."""

    def __init__(self, runtime, *, max_batch_rows: Optional[int] = None,
                 max_wait_ms: float = 2.0, queue_depth: int = 256,
                 deadline_ms: float = 0.0):
        self.runtime = runtime
        self.max_batch_rows = int(max_batch_rows or runtime.max_batch_rows)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1000.0
        self.deadline_s = max(float(deadline_ms), 0.0) / 1000.0
        self._q: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(int(queue_depth), 1))
        # flush staging, keyed by feature width: requests are written
        # straight into this buffer (one copy, no np.concatenate
        # intermediate).  Only the single worker thread touches it, and
        # the runtime consumes the batch synchronously inside
        # `predict`, so reuse across flushes is race-free.
        self._stage: dict = {}  # guarded-by: worker-thread
        # request handoff is the queue itself; per-request results ride
        # each _Request's own done-Event (happens-before via Event.set)
        self._closed = False    # guarded-by: single-writer
        self._worker = threading.Thread(
            target=self._guard, name=f"lgbm-serve-{runtime.name}",
            daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ submit
    def submit(self, X, raw_score: bool = False,
               trace: Optional[telemetry.RequestTrace] = None) -> _Request:
        """Enqueue one request; returns a waitable handle.  A full
        queue sheds immediately (bounded memory under overload)."""
        if self._closed:
            raise ServingClosedError("batcher is closed")
        # already-contiguous f64 input passes through untouched (the
        # runtime trusts contiguous f64 too, so the request path does
        # zero redundant host copies end to end)
        X = np.asarray(X, dtype=np.float64)
        if not X.flags["C_CONTIGUOUS"]:
            X = np.ascontiguousarray(X)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if trace is None:
            trace = telemetry.RequestTrace(model=self.runtime.name,
                                           rows=X.shape[0],
                                           raw=bool(raw_score))
        else:
            trace.model = trace.model or self.runtime.name
            trace.rows = X.shape[0]
            trace.raw = bool(raw_score)
        deadline = (time.monotonic() + self.deadline_s) \
            if self.deadline_s > 0 else None
        req = _Request(X, bool(raw_score), deadline, trace)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            telemetry.REGISTRY.counter("serve.shed").inc()
            telemetry.REGISTRY.counter("serve.shed.queue_full").inc()
            if telemetry.REGISTRY.gauge("serve.swap_windows").value > 0:
                # a registry build-then-swap is in flight: the warmup /
                # export work competes for the device, so this shed is
                # swap-cost, not steady-state load — split it out so the
                # soak harness can prove swap windows never shed silently
                telemetry.REGISTRY.counter("serve.shed.swap_window").inc()
            trace.finish("shed_queue_full", "queue full at submit")
            telemetry.SERVE_RECORDER.record(trace)
            raise ServingOverloadError(
                f"serving queue full ({self._q.maxsize} requests)")
        telemetry.REGISTRY.counter("serve.requests").inc()
        telemetry.REGISTRY.gauge("serve.queue_depth").set(self._q.qsize())
        return req

    def predict(self, X, raw_score: bool = False,
                timeout: Optional[float] = None,
                trace: Optional[telemetry.RequestTrace] = None,
                ) -> np.ndarray:
        """Synchronous submit-and-wait."""
        return self.submit(X, raw_score=raw_score, trace=trace).wait(timeout)

    # ------------------------------------------------------------- worker
    def _guard(self) -> None:
        """The worker thread's outermost frame.  `_loop` returning
        means close(); anything ESCAPING it would previously kill the
        worker silently — every later request then hung until its wait
        timeout with the queue draining nowhere.  Count the crash,
        restart the loop, keep serving."""
        while True:
            try:
                self._loop()
                return
            except BaseException as e:
                if self._closed:
                    return
                telemetry.REGISTRY.counter(
                    "serve.batcher.worker_restarts").inc()
                telemetry.event("serve.batcher.worker_restart",
                                model=self.runtime.name,
                                error=str(e)[:200])

    def _loop(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed:
                    return
                continue
            first.t_dequeued = time.perf_counter()
            batch = [first]
            rows = first.n
            t0 = time.monotonic()
            while rows < self.max_batch_rows:
                remaining = self.max_wait_s - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                nxt.t_dequeued = time.perf_counter()
                batch.append(nxt)
                rows += nxt.n
            telemetry.REGISTRY.gauge("serve.queue_depth").set(
                self._q.qsize())
            try:
                self._flush(batch)
            except BaseException as e:
                # a batcher bug (or the serve.flush chaos fault) must
                # not strand its in-hand batch: fail these requests
                # cleanly, then let _guard restart the loop
                for r in batch:
                    if not r.done.is_set():
                        r.error = ServingClosedError(
                            f"batcher worker crashed: {str(e)[:200]}")
                        self._finalize(r, "error", str(e)[:200])
                        r.done.set()
                raise
            telemetry.REGISTRY.gauge("serve.queue_depth").set(
                self._q.qsize())

    def _flush(self, batch: List[_Request]) -> None:
        FAULTS.inject("serve.flush")
        telemetry.REGISTRY.gauge("serve.in_flight").set(len(batch))
        now = time.monotonic()
        live: List[_Request] = []
        for req in batch:
            if self._closed:
                req.error = ServingClosedError("batcher closed")
                self._finalize(req, "closed", "batcher closed")
                req.done.set()
            elif req.deadline is not None and now > req.deadline:
                # deadline-based load shedding: the caller has given up
                # (or will) — don't burn device time on a dead request
                telemetry.REGISTRY.counter("serve.shed").inc()
                telemetry.REGISTRY.counter("serve.shed.deadline").inc()
                if telemetry.REGISTRY.gauge("serve.swap_windows").value > 0:
                    telemetry.REGISTRY.counter(
                        "serve.shed.swap_window").inc()
                req.error = ServingOverloadError(
                    "request deadline exceeded while queued")
                self._finalize(req, "shed_deadline",
                               "deadline exceeded while queued")
                req.done.set()
            else:
                live.append(req)
        if not live:
            telemetry.REGISTRY.gauge("serve.in_flight").set(0)
            return
        groups = {}
        for req in live:
            groups.setdefault((req.raw, req.X.shape[1]), []).append(req)
        with telemetry.span("serve.batch", requests=len(live),
                            rows=sum(r.n for r in live),
                            groups=len(groups)):
            for (raw, _w), reqs in groups.items():
                self._run_group(reqs, raw)
        telemetry.REGISTRY.counter("serve.batches").inc()
        telemetry.REGISTRY.gauge("serve.in_flight").set(0)

    def _run_group(self, reqs: List[_Request], raw: bool) -> None:
        t_group = time.perf_counter()
        clock = telemetry.StageClock()
        try:
            if len(reqs) == 1:
                X = reqs[0].X
                build_dt = 0.0
            else:
                total = sum(r.n for r in reqs)
                w = reqs[0].X.shape[1]
                buf = self._stage.get(w)
                if buf is None or buf.shape[0] < total:
                    buf = np.empty((max(total, self.max_batch_rows), w),
                                   np.float64)
                    self._stage[w] = buf
                lo = 0
                for r in reqs:
                    buf[lo:lo + r.n] = r.X
                    lo += r.n
                X = buf[:total]
                build_dt = time.perf_counter() - t_group
            out = self.runtime.predict(X, raw_score=raw, clock=clock)
            # the group-assembly copy is staging work too; added after
            # predict() so its convert-remainder accounting stays exact
            clock.add("stage_copy", build_dt)
            rt_end = time.perf_counter()
            lo = 0
            done_t = time.monotonic()
            for r in reqs:
                r.result = out[lo:lo + r.n]
                lo += r.n
                telemetry.REGISTRY.timing("serve.latency").observe(
                    done_t - r.enqueued)
                if r.trace is not None:
                    tr = r.trace
                    tr.add_stage("queue_wait", r.t_dequeued - r.t_submit)
                    tr.add_stage("coalesce", t_group - r.t_dequeued)
                    tr.merge_clock(clock)
                    tr.add_stage("finish", time.perf_counter() - rt_end)
                    tr.finish("ok")
                    telemetry.observe_stages(tr)
                    telemetry.SERVE_RECORDER.record(tr)
                r.done.set()
        except BaseException as e:
            for r in reqs:
                if not r.done.is_set():
                    r.error = e
                    self._finalize(r, "error", str(e)[:200], clock)
                    r.done.set()

    def _finalize(self, req: _Request, status: str, why: str,
                  clock: Optional[telemetry.StageClock] = None) -> None:
        """Terminal bookkeeping for a request that did NOT complete
        normally: finalize its trace once and offer it to the recorder
        (shed / error / closed traces are always kept)."""
        tr = req.trace
        if tr is None or tr.status is not None:
            return
        if clock is not None:
            tr.merge_clock(clock)
        if req.t_dequeued:
            tr.add_stage("queue_wait", req.t_dequeued - req.t_submit)
        tr.finish(status, why)
        telemetry.SERVE_RECORDER.record(tr)

    # -------------------------------------------------------------- close
    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker and fail any still-queued request."""
        if self._closed:
            return
        self._closed = True
        self._worker.join(timeout)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.error = ServingClosedError("batcher closed")
            self._finalize(req, "closed", "batcher closed")
            req.done.set()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
