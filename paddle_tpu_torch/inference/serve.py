"""HTTP front-end of the serving engine (``paddle_tpu.inference.serve``
``build_http_server`` counterpart, /generate, /healthz, /stats and
/metrics).

Imports nothing of the port's model code: the engine and the router
inject their generate/admit/health/stats/metrics callables. The /run endpoint of the JAX
package serves exported StableHLO artifacts and is not ported.
"""
from __future__ import annotations

import json
import math
import time

__all__ = ["build_http_server"]


DEFAULT_QUEUE_LIMIT = 32        # == FLAGS_serving_queue_limit default
DEFAULT_TIMEOUT_S = 60.0        # == FLAGS_serving_request_timeout_s default
DEFAULT_MAX_BODY_MB = 8         # == FLAGS_serving_max_body_mb default


def build_http_server(port: int, generate_fn=None, *,
                      queue_limit: int = DEFAULT_QUEUE_LIMIT,
                      timeout_s: float = DEFAULT_TIMEOUT_S,
                      max_body_bytes: int = DEFAULT_MAX_BODY_MB << 20,
                      host: str = "127.0.0.1",
                      admit_fn=None, health_fn=None, stats_fn=None,
                      metrics_fn=None):
    """The serving HTTP front-end, dependency-injected:

      * POST /generate -> generate_fn(payload dict, deadline) yielding event
                          dicts, streamed as one JSON line each (ndjson);
      * GET /healthz   -> health_fn() dict as JSON (503 when it carries
                          ``"ok": False`` or health_fn raises);
      * GET /stats     -> stats_fn() dict as JSON;
      * GET /metrics   -> metrics_fn() string served as Prometheus text
                          exposition (format 0.0.4), the observability
                          registry's scrape endpoint. GETs bypass the
                          bounded POST queue, so a saturated engine still
                          answers its probes.

    ``admit_fn(payload) -> None | dict`` is consulted BEFORE the 200 of a
    /generate: ``{"status": 503, "retry_after": 1.0, "message": ...}``
    refuses the request with that status and a Retry-After header.

    Hardening as in the JAX package: a ThreadingHTTPServer; more than
    `queue_limit` in-flight POST handlers are answered 503; bodies past
    `max_body_bytes` get 413, chunked or unknown lengths 411, malformed
    400; socket reads and writes and the whole /generate stream are bounded
    by `timeout_s`.
    """
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    slots = threading.BoundedSemaphore(queue_limit)

    class Handler(BaseHTTPRequestHandler):
        # bounds the REQUEST-LINE/HEADER phase too: without it a client
        # that connects and sends nothing parks a handler thread forever
        # without ever reaching do_POST's queue accounting
        timeout = timeout_s

        def _body(self):
            cl = self.headers.get("Content-Length")
            if cl is None:
                self.send_error(411, "Content-Length required")
                return None
            try:
                n = int(cl)
            except ValueError:
                self.send_error(400, "malformed Content-Length")
                return None
            if n < 0:
                self.send_error(400, "malformed Content-Length")
                return None
            if n > max_body_bytes:
                self.send_error(413, f"body exceeds {max_body_bytes} bytes")
                return None
            return self.rfile.read(n)

        def _json_reply(self, obj: dict, status: int = 200,
                        extra_headers: dict | None = None):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            # no slot accounting: probes must answer even when the POST
            # queue is saturated (a probe that 503s under load reads as a
            # dead replica and triggers a spurious drain)
            try:
                if self.path == "/healthz" and health_fn is not None:
                    h = dict(health_fn())
                    self._json_reply(h, 200 if h.get("ok", True) else 503)
                elif self.path == "/stats" and stats_fn is not None:
                    self._json_reply(dict(stats_fn()))
                elif self.path == "/metrics" and metrics_fn is not None:
                    data = str(metrics_fn()).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self.send_error(404)
            except Exception as e:
                self._json_reply(
                    {"ok": False, "error": f"{type(e).__name__}: {e}"}, 503)

        def do_POST(self):
            if not slots.acquire(blocking=False):
                self.send_error(503, "request queue full")
                return
            try:
                self.connection.settimeout(timeout_s)
                deadline = time.monotonic() + timeout_s
                if self.path == "/generate" and generate_fn is not None:
                    self._do_generate(deadline)
                else:
                    self.send_error(404)
            finally:
                slots.release()

        def _do_generate(self, deadline):
            body = self._body()
            if body is None:
                return
            try:
                payload = json.loads(body)
            except Exception:
                self.send_error(400, "body must be JSON")
                return
            if admit_fn is not None:
                rej = admit_fn(payload)
                if rej:  # refuse BEFORE the 200: clean status + Retry-After
                    hdrs = {}
                    if rej.get("retry_after") is not None:
                        # RFC 9110 delta-seconds is an INTEGER; a float
                        # string gets discarded by strict clients
                        hdrs["Retry-After"] = math.ceil(
                            float(rej["retry_after"]))
                    self._json_reply(
                        {"error": rej.get("message", "rejected")},
                        int(rej.get("status", 503)), hdrs)
                    return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            # close-delimited stream: one JSON line per event, flushed as
            # the scheduler emits tokens
            self.end_headers()
            try:
                for event in generate_fn(payload, deadline):
                    self.wfile.write((json.dumps(event) + "\n").encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away; engine-side cancel already ran
            except Exception as e:
                # headers are already out — surface bad payloads and
                # engine errors as a terminal stream event, not a cut
                # connection
                try:
                    self.wfile.write(
                        (json.dumps({"error": f"{type(e).__name__}: {e}"})
                         + "\n").encode())
                except OSError:
                    pass

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.daemon_threads = True
    return srv
