"""Resilience plane of the serving path: fault injection, watchdogs,
breakers (the port's copy of `lightgbm_tpu/resilience/`).

 - ``FAULTS`` / ``FaultPlane`` (faults.py) — named injection sites
   arming exceptions, latency, hangs and payload corruption;
 - ``Supervisor`` / ``DeviceTimeoutError`` (supervise.py) — deadline-
   bounded calls at every device boundary;
 - ``CircuitBreaker`` (breaker.py) — per-rung closed / open /
   half_open / permanent gating with exponential-backoff background
   re-probes.

The crash-safe state files (`state.py`) serve the fleet daemon and wait
for ROADMAP Queue 1 item 5g.  Stdlib only.
"""
from .breaker import CLOSED, HALF_OPEN, OPEN, PERMANENT, CircuitBreaker
from .faults import FAULTS, FaultInjected, FaultPlane, FaultSpec
from .supervise import DeviceTimeoutError, Supervisor

__all__ = [
    "CLOSED", "HALF_OPEN", "OPEN", "PERMANENT", "CircuitBreaker",
    "FAULTS", "FaultInjected", "FaultPlane", "FaultSpec",
    "DeviceTimeoutError", "Supervisor",
]
