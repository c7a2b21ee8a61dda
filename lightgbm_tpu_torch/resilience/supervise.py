"""Watchdog-supervised dispatch: the port's copy of
`lightgbm_tpu/resilience/supervise.py`.

A device interaction can simply never return, and an ``except
Exception`` around it is then dead code.  ``Supervisor``
bounds any call in wall-clock: the call runs on a persistent worker
thread while the caller waits with a deadline; a call that outlives its
deadline is ABANDONED (Python threads cannot be killed — the worker is
retired and a fresh one serves the next call) and the caller gets a
``DeviceTimeoutError``, which the serving runtime treats like any other
device failure (its rung's breaker opens and the request raises).  A
wedged device therefore costs one deadline per breaker-open, not a
wedged process.

``timeout_ms <= 0`` (the default for every ``*_timeout_ms`` param)
bypasses the machinery entirely — a direct call, zero threads, zero
overhead — so supervision is opt-in per deployment and always-on in
the chaos tests.

Telemetry: ``serve.watchdog.fired{site=}`` counts every abandonment.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional

from ..telemetry.metrics import REGISTRY
from ..utils.locks import make_lock

from ..utils.log import LightGBMError


class DeviceTimeoutError(LightGBMError):
    """A supervised call outlived its deadline and was abandoned."""


class _Job:
    __slots__ = ("fn", "args", "kwargs", "done", "result", "exc",
                 "abandoned")

    def __init__(self, fn, args, kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.done = threading.Event()
        self.result: Any = None
        self.exc: Optional[BaseException] = None
        self.abandoned = False


def _worker(q: "queue.Queue") -> None:
    while True:
        job = q.get()
        if job is None:          # retirement sentinel (post-abandon)
            return
        try:
            job.result = job.fn(*job.args, **job.kwargs)
        except BaseException as e:  # delivered to the waiter
            job.exc = e
        job.done.set()


class Supervisor:
    """Deadline-bounded call wrapper for one named site.

    One persistent worker thread serves calls in order (device
    boundaries are already serialized per runtime, so a single lane
    loses no parallelism).  On timeout the worker is abandoned mid-call
    and replaced lazily: the wedged call keeps its zombie thread until
    it returns (or the armed hang is released), after which the
    retirement sentinel ends it.
    """

    def __init__(self, site: str, timeout_ms: float = 0.0):
        self.site = site
        self.timeout_s = max(float(timeout_ms), 0.0) / 1000.0
        self._lock = make_lock("resilience.supervise._lock")
        self._q: Optional[queue.Queue] = None  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def call(self, fn: Callable, *args, **kwargs) -> Any:
        """Run ``fn`` under the deadline; transparent when disabled."""
        if self.timeout_s <= 0:
            return fn(*args, **kwargs)
        job = _Job(fn, args, kwargs)
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._q = queue.Queue()
                self._thread = threading.Thread(
                    target=_worker, args=(self._q,), daemon=True,
                    name=f"lgbm-watchdog-{self.site}")
                self._thread.start()
            q = self._q
        q.put(job)
        if not job.done.wait(self.timeout_s):
            job.abandoned = True
            with self._lock:
                # retire THIS worker lane (the zombie drains the
                # sentinel after its wedged call finally returns); a
                # concurrent call may already have replaced it
                if self._q is q:
                    self._q = None
                    self._thread = None
            q.put(None)
            REGISTRY.counter("serve.watchdog.fired", site=self.site).inc()
            raise DeviceTimeoutError(
                f"supervised call at {self.site} exceeded its "
                f"{self.timeout_s * 1000:g} ms deadline and was "
                "abandoned (watchdog)")
        if job.exc is not None:
            raise job.exc
        return job.result
