"""stdlib HTTP frontend of the serving plane (`make_server`), the port's
copy of `lightgbm_tpu/serving/http.py`.

Endpoints (JSON in/out, no dependencies beyond http.server):

  POST /predict   {"rows": [[...], ...], "model": "default",
                   "raw_score": false}
                  -> {"model", "rows", "predictions", "request_id"}
                  Predictions ride as JSON numbers; Python float repr
                  is shortest-roundtrip, so the f64 values parse back
                  bit-exact.
  GET  /healthz   -> {"status": "ok", "models": [...], "stale": [...],
                  "demoted": [...], "device_bytes": {...},
                  "rungs": {...}, "bounded": {...}, "latency_ms": {...}}
                  (503 when no model is loaded; `rungs` gives each
                  model's answering rung, why it was chosen and its
                  breakers' states — see ModelRegistry.status)
  GET  /metrics   -> Prometheus text exposition of the process
                  MetricsRegistry (serve.* counters/gauges/timings plus
                  the per-rung `serve.stage.*` histograms)
  GET  /debug/requests[?n=K]
                  -> the tail-sampled serving flight-recorder ring
                  (telemetry.SERVE_RECORDER.snapshot()); a non-integer
                  or negative `n` is a 400
  GET  /debug/fleet, /debug/memory
                  -> 404: the fleet snapshot and the memory ledger wait
                  for ROADMAP Queue 1 item 5g

Trace-header contract: a caller may send `X-Request-Id: <token>`; the
id (or a generated one) tags the request's `RequestTrace`, comes back
as an `X-Request-Id` response header AND a `request_id` body field on
every /predict response — success or error — and is searchable in
`/debug/requests`.

Status codes: malformed bodies 400, unknown models and paths 404, a
Content-Length above `serve_max_body_mb` 413 before the body is read,
and 503 with `Retry-After` for a shed request (`ServingOverloadError`),
a failed device dispatch (`ServingDeviceError`) and an open breaker
(`ServingUnavailableError`).  The command-line server (`python -m
lightgbm_tpu serve`) waits for item 5g with the CLI.
"""
from __future__ import annotations

import json
import math
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from .. import telemetry
from ..utils import log
from ..utils.log import LightGBMError
from .batcher import ServingOverloadError
from .client import ServingClient
from .runtime import ServingDeviceError, ServingUnavailableError

#: the ROADMAP item the JAX package's fleet endpoint waits for
_WAITS = "the fleet snapshot waits for ROADMAP Queue 1 item 5g"


class ServingHTTPHandler(BaseHTTPRequestHandler):
    """One handler class per server (see `make_server`): the bound
    `client` rides as a class attribute so the stdlib's
    handler-per-request instantiation needs no closure plumbing."""

    client: ServingClient = None  # bound by make_server
    server_version = "lightgbm-tpu-torch-serve/1.0"
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: the headers and the body leave in two sends; under
    # Nagle's algorithm the body of a response on a kept-alive
    # connection can wait for the client's delayed ACK of the headers
    disable_nagle_algorithm = True

    # stdlib default logs every request to stderr unconditionally —
    # route through the library logger (verbosity-gated) instead
    def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
        log.debug(f"[serve] {self.address_string()} {fmt % args}")

    def _send_json(self, code: int, payload: dict,
                   request_id: Optional[str] = None,
                   retry_after: Optional[int] = None) -> None:
        headers = []
        if request_id:
            payload = dict(payload, request_id=request_id)
            headers.append(("X-Request-Id", request_id))
        if retry_after is not None:
            headers.append(("Retry-After", str(retry_after)))
        self._send(code, "application/json",
                   json.dumps(payload).encode("utf-8"), headers)

    def _send_text(self, code: int, text: str,
                   ctype: str = "text/plain; version=0.0.4") -> None:
        self._send(code, ctype, text.encode("utf-8"))

    def _send(self, code: int, ctype: str, body: bytes,
              headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _retry_after_s(self) -> int:
        """Retry-After for a 503: the breakers' first backoff, >= 1 s."""
        try:
            backoff = float(
                self.client.registry._config.serve_breaker_backoff_s)
        except AttributeError:
            backoff = 1.0
        return max(1, int(math.ceil(backoff)))

    def _max_body_mb(self) -> float:
        """The serve_max_body_mb cap of the bound client's registry
        config (0 or a missing config disables the cap)."""
        try:
            return float(self.client.registry._config.serve_max_body_mb)
        except AttributeError:
            return 0.0

    def _query_limit(self, query: str, default: Optional[int] = None):
        """Parse the shared `?n=K` limit of the /debug endpoints.
        Returns (ok, limit); on a non-integer or NEGATIVE n the 400 has
        already been sent (a stack trace is not an API response) and ok
        is False."""
        qs = urllib.parse.parse_qs(query)
        if "n" not in qs:
            return True, default
        try:
            limit = int(qs["n"][0])
        except (ValueError, IndexError):
            self._send_json(400, {"error": "n must be an integer"})
            return False, None
        if limit < 0:
            self._send_json(400, {"error": "n must be >= 0"})
            return False, None
        return True, limit

    # --------------------------------------------------------------- GET
    def do_GET(self) -> None:  # noqa: N802 (stdlib name)
        telemetry.REGISTRY.counter("serve.http.requests").inc()
        url = urllib.parse.urlsplit(self.path)
        if url.path == "/healthz":
            st = self.client.status()
            models = st["models"]
            payload = {"status": "ok" if models else "no_models",
                       "models": models,
                       "stale": st["stale"],
                       "demoted": st["demoted"],
                       "device_bytes": st["device_bytes"],
                       "rungs": st["rungs"]}
            if "bounded" in st:
                payload["bounded"] = st["bounded"]
            if "latency_ms" in st:
                payload["latency_ms"] = st["latency_ms"]
            self._send_json(200 if models else 503, payload)
        elif url.path == "/metrics":
            self._send_text(200, telemetry.REGISTRY.to_prometheus())
        elif url.path == "/debug/requests":
            ok, limit = self._query_limit(url.query)
            if not ok:
                return
            self._send_json(
                200, telemetry.SERVE_RECORDER.snapshot(limit=limit))
        elif url.path == "/debug/memory":
            # the attributed owners and the allocator's reconcile, run on
            # this debug request, not on a serving thread
            self._send_json(200, telemetry.MEMLEDGER.debug_snapshot())
        elif url.path == "/debug/fleet":
            self._send_json(404, {"error": f"{url.path}: {_WAITS}"})
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    # -------------------------------------------------------------- POST
    def do_POST(self) -> None:  # noqa: N802 (stdlib name)
        telemetry.REGISTRY.counter("serve.http.requests").inc()
        if self.path != "/predict":
            self._send_json(404, {"error": f"unknown path {self.path}"})
            return
        with telemetry.span("serve.http.predict"):
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (ValueError, TypeError):
                telemetry.REGISTRY.counter("serve.http.bad_requests").inc()
                self._send_json(400, {"error": "bad Content-Length"})
                return
            # cap BEFORE reading: an oversized declared body never
            # allocates (and never monopolises the socket reader) —
            # the unread body means the connection must close
            cap = int(self._max_body_mb() * 1024 * 1024)
            if cap > 0 and length > cap:
                telemetry.REGISTRY.counter(
                    "serve.http.body_too_large").inc()
                self.close_connection = True
                self._send_json(413, {
                    "error": f"request body {length} bytes exceeds "
                             f"serve_max_body_mb="
                             f"{self._max_body_mb():g} "
                             f"({cap} bytes)"})
                return
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                rows = body["rows"]
                X = np.asarray(rows, dtype=np.float64)
                if X.ndim == 1:
                    X = X.reshape(1, -1)
                if X.ndim != 2 or X.shape[0] == 0:
                    raise ValueError("rows must be a non-empty 2-D "
                                     "number array")
            except (KeyError, ValueError, TypeError) as e:
                telemetry.REGISTRY.counter("serve.http.bad_requests").inc()
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            model = str(body.get("model", "default"))
            raw = bool(body.get("raw_score", False))
            # trace creation AFTER parsing: its e2e then brackets exactly
            # the stages the batcher/runtime stamp, which is what makes
            # stage-sum ≈ e2e hold (the /debug/requests contract)
            rid = self.headers.get("X-Request-Id") or None
            tr = telemetry.RequestTrace(request_id=rid, model=model,
                                        rows=int(X.shape[0]), raw=raw)
            try:
                preds = self.client.predict(X, model=model, raw_score=raw,
                                            trace=tr)
            except ServingOverloadError as e:
                self._trace_error(tr, "shed_overload", e)
                self._send_json(503, {"error": str(e)}, request_id=tr.id,
                                retry_after=1)
                return
            except (ServingDeviceError, ServingUnavailableError) as e:
                telemetry.REGISTRY.counter("serve.http.unavailable").inc()
                self._trace_error(tr, "error", e)
                self._send_json(503, {"error": str(e)[:500]},
                                request_id=tr.id,
                                retry_after=self._retry_after_s())
                return
            except LightGBMError as e:
                # unknown model name (or model-shape errors): caller bug
                self._trace_error(tr, "error", e)
                self._send_json(404, {"error": str(e)}, request_id=tr.id)
                return
            except Exception as e:
                telemetry.REGISTRY.counter("serve.http.errors").inc()
                self._trace_error(tr, "error", e)
                self._send_json(500, {"error": str(e)[:500]},
                                request_id=tr.id)
                return
            self._send_json(200, {"model": model,
                                  "rows": int(X.shape[0]),
                                  "predictions": np.asarray(preds).tolist()},
                            request_id=tr.id)

    @staticmethod
    def _trace_error(tr, status: str, e: BaseException) -> None:
        """Finalize+record a trace the batcher never terminated (e.g.
        an unknown model fails before submit); traces the batcher
        already finalized — sheds, group errors — pass through."""
        if tr.status is None:
            tr.finish(status, str(e)[:200])
            telemetry.SERVE_RECORDER.record(tr)


def make_server(client: ServingClient, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """Threaded HTTP server bound to `client` (port 0 = ephemeral —
    read the real one from `server.server_address`; tests and the CI
    smoke drive it from a background thread and call `shutdown()`)."""
    handler = type("BoundServingHTTPHandler", (ServingHTTPHandler,),
                   {"client": client})
    return ThreadingHTTPServer((host, port), handler)

