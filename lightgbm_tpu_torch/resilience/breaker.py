"""Per-rung circuit breakers: the port's copy of
`lightgbm_tpu/resilience/breaker.py`.

Before this module, a serving rung that failed its refresh-time parity
probe with a device EXCEPTION was disabled until the next manual
``refresh()`` — a transient device error demoted a model to a slower
rung indefinitely.  The breaker makes transient failures recoverable:

    closed     the rung serves; failures open the breaker
    open       the rung is skipped (no request ever pays a wedged
               device's deadline twice); after ``backoff_s`` the next
               request may promote the breaker to half_open
    half_open  one BACKGROUND re-probe is in flight (requests still
               skip the rung — a probe is never run on a request
               thread); probe pass closes, probe failure re-opens with
               the backoff doubled (capped at ``backoff_max_s``)
    permanent  the parity probe failed on CONTENT (a byte mismatch,
               not an exception): the device computes wrong bits, and
               no amount of waiting fixes wrong — only a full
               ``refresh()`` (new export, fresh probes) re-evaluates

Transitions are counted under ``serve.breaker.transitions{breaker=,
state=}`` and the current state is exported as the
``serve.breaker.state{breaker=}`` gauge (0 closed, 1 half_open, 2 open,
3 permanent) so a dashboard can see a rung flapping.

Time is injected (``clock``) for deterministic tests.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from ..telemetry.metrics import REGISTRY
from ..utils.locks import make_lock

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
PERMANENT = "permanent"

_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2, PERMANENT: 3}


class CircuitBreaker:
    """One rung's gate.  Thread-safe; every method is O(1)."""

    def __init__(self, name: str, backoff_s: float = 30.0,
                 backoff_max_s: float = 600.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.backoff_s = max(float(backoff_s), 0.0)
        self.backoff_max_s = max(float(backoff_max_s), self.backoff_s)
        self._clock = clock
        self._lock = make_lock("resilience.breaker._lock")
        # writes only under _lock (via _to); the lock-free `state` read
        # path is the documented single-field staleness trade
        self._state = CLOSED                 # guarded-by: _lock
        self._cur_backoff = self.backoff_s   # guarded-by: _lock
        self._retry_at = 0.0                 # guarded-by: _lock
        self.failures = 0                    # guarded-by: _lock

    # ------------------------------------------------------------ reads
    @property
    def state(self) -> str:
        return self._state

    def allow_request(self) -> bool:
        """May a REQUEST use the rung right now?  Pure read: requests
        never probe — recovery runs in the background."""
        return self._state == CLOSED

    def begin_probe(self) -> bool:
        """Claim the half-open re-probe slot: True exactly once per
        open period, once the backoff has elapsed.  The claimant must
        follow up with ``record_success`` / ``record_failure`` /
        ``record_mismatch``."""
        with self._lock:
            if self._state != OPEN or self._clock() < self._retry_at:
                return False
            self._to(HALF_OPEN)
            return True

    # ------------------------------------------------------ transitions
    def record_success(self) -> None:
        """Parity probe passed (or refresh re-validated the rung)."""
        with self._lock:
            self.failures = 0
            self._cur_backoff = self.backoff_s
            if self._state != CLOSED:
                self._to(CLOSED)

    def record_failure(self) -> None:
        """Device exception / watchdog timeout: open (or re-open with
        the backoff doubled after a failed half-open probe)."""
        with self._lock:
            if self._state == PERMANENT:
                return
            self.failures += 1
            if self._state == HALF_OPEN:
                self._cur_backoff = min(self._cur_backoff * 2,
                                        self.backoff_max_s)
            self._retry_at = self._clock() + self._cur_backoff
            if self._state != OPEN:
                self._to(OPEN)

    def record_mismatch(self) -> None:
        """Parity probe failed on CONTENT — permanent by design (only
        a full refresh with a new export re-evaluates)."""
        with self._lock:
            self.failures += 1
            if self._state != PERMANENT:
                self._to(PERMANENT)

    def reset(self) -> None:
        """Back to closed with a fresh backoff — a ``refresh()`` is a
        new export whose probes re-derive every verdict."""
        with self._lock:
            self.failures = 0
            self._cur_backoff = self.backoff_s
            self._retry_at = 0.0
            if self._state != CLOSED:
                self._to(CLOSED)

    def _to(self, state: str) -> None:
        # caller holds the lock
        self._state = state
        REGISTRY.counter("serve.breaker.transitions",
                         breaker=self.name, state=state).inc()
        REGISTRY.gauge("serve.breaker.state",
                       breaker=self.name).set(_STATE_CODE[state])
