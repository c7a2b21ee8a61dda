"""Process-global fault-injection plane.

Every device boundary of the serving ladder is guarded by error paths
(its rung's breaker, the request's `ServingDeviceError`) that would
otherwise be reachable only by monkeypatch.  This module makes them
reachable *deliberately*: the code under test calls
``FAULTS.inject("<site>")`` at each boundary it wants to be breakable
— a no-op dict lookup when nothing is armed — and tests / the CI chaos
smoke arm named faults against those sites.

Spec grammar (comma-separated entries, ``fault_spec`` param or the
``LGBM_FAULTS`` environment variable)::

    site:mode[:arg][@p=P][@n=N][@after=K]

    serve.dispatch.device_sum:hang          hang forever (until disarm)
    prefetch.read:error@after=2             3rd read onward raises
    compiled.traverse:delay:0.05@p=0.5      50% of calls sleep 50 ms
    serve.d2h.device_sum:corrupt@n=1        flip bytes of one payload

``site`` is an ``fnmatch`` glob, so ``serve.dispatch.*:error`` breaks
every rung at once.  Modes:

    error    raise ``FaultInjected`` at the site
    hang     block on an Event for ``arg`` seconds (default 1 h);
             ``disarm()`` releases every hung thread, so tests never
             leak sleepers — the watchdog (supervise.py) is what turns
             the hang into a ``DeviceTimeoutError`` meanwhile
    delay    sleep ``arg`` seconds (default 10 ms), then continue
    corrupt  return a byte-flipped COPY of the payload handed to
             ``inject`` (ndarray-shaped payloads only; sites that pass
             no payload treat corrupt as a no-op)

``@p`` is the per-call trigger probability (default 1), ``@n`` caps the
total trigger count (default unlimited), ``@after`` lets the first K
matching calls pass untouched (mid-stream faults).

The port's copy of `lightgbm_tpu/resilience/faults.py`, stdlib only.
"""
from __future__ import annotations

import fnmatch
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils.locks import make_lock

ENV_VAR = "LGBM_FAULTS"

#: default hang horizon — long enough to be "forever" for any watchdog,
#: short enough that an abandoned worker cannot outlive a CI job
HANG_DEFAULT_S = 3600.0
DELAY_DEFAULT_S = 0.01

_MODES = ("error", "hang", "delay", "corrupt")


class FaultInjected(RuntimeError):
    """Raised at an armed ``error`` site.  A plain RuntimeError
    subclass: the production code must treat it exactly like any other
    device/IO failure (that is the point)."""


class FaultSpec:
    """One parsed ``site:mode[:arg][@p][@n][@after]`` entry."""

    __slots__ = ("pattern", "mode", "arg", "p", "n", "after",
                 "fired", "skipped")

    def __init__(self, pattern: str, mode: str,
                 arg: Any = None,  # float via the grammar; tests may
                 # pass a str message for error mode programmatically
                 p: float = 1.0, n: int = 0, after: int = 0):
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r} "
                             f"(expected one of {_MODES})")
        self.pattern = pattern
        self.mode = mode
        self.arg = arg
        self.p = float(p)
        self.n = int(n)          # max triggers, 0 = unlimited
        self.after = int(after)  # matching calls to pass through first
        self.fired = 0
        self.skipped = 0

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        body, _, mods = text.partition("@")
        parts = body.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"bad fault spec {text!r}: expected site:mode[:arg]")
        pattern, mode = parts[0].strip(), parts[1].strip().lower()
        arg = float(parts[2]) if len(parts) > 2 and parts[2] else None
        kw: Dict[str, float] = {}
        if mods:
            for tok in mods.split("@"):
                k, _, v = tok.partition("=")
                k = k.strip().lower()
                if k not in ("p", "n", "after") or not v:
                    raise ValueError(
                        f"bad fault modifier {tok!r} in {text!r} "
                        "(expected @p=… @n=… @after=…)")
                kw[k] = float(v)
        return cls(pattern, mode, arg, p=kw.get("p", 1.0),
                   n=int(kw.get("n", 0)), after=int(kw.get("after", 0)))

    def describe(self) -> str:
        out = f"{self.pattern}:{self.mode}"
        if isinstance(self.arg, str):
            out += f":{self.arg}"
        elif self.arg is not None:
            out += f":{self.arg:g}"
        if self.p != 1.0:
            out += f"@p={self.p:g}"
        if self.n:
            out += f"@n={self.n}"
        if self.after:
            out += f"@after={self.after}"
        return out


class FaultPlane:
    """Registry of armed faults, matched by site name at inject time.

    Process-global instance: ``FAULTS``.  Thread-safe; the disarmed
    fast path is a single attribute read (``self._specs`` empty tuple).
    """

    def __init__(self, env: Optional[str] = None):
        self._lock = make_lock("resilience.faults._lock")
        # written under _lock as an immutable-snapshot tuple swap; the
        # disarmed fast path reads it lock-free by design, so the
        # attribute is deliberately NOT annotated for R007
        self._specs: tuple = ()
        self._release = threading.Event()
        self._rng = random.Random(0)  # guarded-by: _lock
        #: per-(site, mode) trigger counts, for assertions and the
        #: telemetry bridge at the integration layers
        self.fired: Dict[str, int] = {}  # guarded-by: _lock
        spec = os.environ.get(ENV_VAR, "") if env is None else env
        if spec:
            self.arm(spec)

    # ------------------------------------------------------------ arming
    def arm(self, spec: Any) -> List[FaultSpec]:
        """Arm one or more faults: a grammar string, a ``FaultSpec``,
        or a list of either.  Armed faults ACCUMULATE until
        ``disarm()``."""
        new: List[FaultSpec] = []
        items = spec if isinstance(spec, (list, tuple)) else [spec]
        for item in items:
            if isinstance(item, FaultSpec):
                new.append(item)
                continue
            for entry in str(item).split(","):
                entry = entry.strip()
                if entry:
                    new.append(FaultSpec.parse(entry))
        with self._lock:
            self._specs = self._specs + tuple(new)
            self._release.clear()
        return new

    def disarm(self) -> None:
        """Clear every armed fault and release every hung thread."""
        with self._lock:
            self._specs = ()
            self._release.set()

    def active(self) -> bool:
        return bool(self._specs)

    def specs(self) -> List[FaultSpec]:
        return list(self._specs)

    # ----------------------------------------------------------- inject
    def inject(self, site: str, payload: Any = None) -> Any:
        """The instrumentation hook: no-op (returning ``payload``
        untouched) unless an armed spec matches ``site``."""
        specs = self._specs
        if not specs:
            return payload
        for spec in specs:
            if not fnmatch.fnmatchcase(site, spec.pattern):
                continue
            with self._lock:
                if spec.n and spec.fired >= spec.n:
                    continue
                if spec.skipped < spec.after:
                    spec.skipped += 1
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                spec.fired += 1
                key = f"{site}:{spec.mode}"
                self.fired[key] = self.fired.get(key, 0) + 1
                release = self._release
            payload = self._trigger(site, spec, payload, release)
        return payload

    def _trigger(self, site: str, spec: FaultSpec, payload: Any,
                 release: threading.Event) -> Any:
        if spec.mode == "error":
            # a string arg becomes the message verbatim (programmatic
            # FaultSpec only — the grammar parses args as floats): tests
            # simulate status-text-matched failures, e.g. a
            # RESOURCE_EXHAUSTED for the OOM-forensics path
            if isinstance(spec.arg, str):
                raise FaultInjected(f"{spec.arg} (injected at {site})")
            raise FaultInjected(
                f"injected fault at {site} ({spec.describe()})")
        if spec.mode == "delay":
            time.sleep(spec.arg if spec.arg is not None
                       else DELAY_DEFAULT_S)
            return payload
        if spec.mode == "hang":
            # the hung thread parks on the plane's release event: the
            # watchdog abandons it after its deadline, and disarm()
            # frees it so no test run leaks a sleeper
            release.wait(spec.arg if spec.arg is not None
                         else HANG_DEFAULT_S)
            return payload
        # corrupt: byte-flip a COPY of an ndarray-shaped payload (the
        # caller's array is never mutated in place); payload-free sites
        # have nothing to corrupt and pass through
        if payload is None:
            return payload
        try:
            bad = payload.copy()
            view = bad.view("uint8") if bad.ndim else None
            if view is None or view.size == 0:
                return payload
            view.flat[0] ^= 0xFF
            return bad
        except (AttributeError, ValueError, TypeError):
            return payload

    def fired_at(self, site_prefix: str) -> int:
        """Total triggers whose site starts with ``site_prefix``."""
        with self._lock:
            fired = dict(self.fired)
        return sum(v for k, v in fired.items()
                   if k.startswith(site_prefix))


#: the process-global plane, armed from $LGBM_FAULTS at import
FAULTS = FaultPlane()
