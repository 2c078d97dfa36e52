"""Minimal stdlib HTTP front end for a ``ModelServer`` (counterpart of
``transmogrifai_tpu.serving.http``): every handler thread parks on a
batcher future while the one dispatch thread scores.

Endpoints:
  POST /score    {"rows": [{...}, ...], "timeoutMs": 50} -> {"scores": [...]}
                 (shed rows come back as their ShedResult JSON and make the
                 response a 503; a batch whose scoring failed, a 500)
  GET  /metrics  the serving metrics snapshot (JSON);
                 ``?format=prometheus``: the Prometheus text exposition of
                 the snapshot and the run ledger (``obs/prometheus.py``)
  GET  /healthz  {"status": "ok" | "degraded" | "draining" | "no_model",
                 "model": {...}, "breakerState": ..., "shedRate": ...,
                 "draining": ...}
  POST /swap     {"path": "/models/titanic_v2"} -> the new entry
  POST /drain    stop admitting; in-flight work completes
The multi-tenant ``/tenants`` route and the fabric's health document are
not ported.  Connections carry a server-side socket timeout, so a stalled
client releases its handler thread.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from .admission import ShedResult

__all__ = ["make_http_server", "serve_forever", "healthz_doc"]


def healthz_doc(srv) -> Tuple[bool, dict]:
    """(model present, the ``/healthz`` document) of a server."""
    entry = srv.registry.maybe_get(srv.name)
    breaker_state = srv.breaker.state
    status = "ok" if entry else "no_model"
    if entry and breaker_state != srv.breaker.CLOSED:
        status = "degraded"
    if entry and srv.draining:
        status = "draining"
    snap = srv.metrics.snapshot()
    offered = snap["requests"] + snap["shed"]
    return entry is not None, {
        "status": status,
        "model": entry.describe() if entry else None,
        "breakerState": breaker_state,
        "lastDeviceError": snap["lastDeviceError"],
        "shedRate": round(snap["shed"] / offered, 4) if offered else 0.0,
        "draining": srv.draining,
    }


def make_http_server(server, host: str = "127.0.0.1", port: int = 8080,
                     request_timeout_s: float = 30.0) -> ThreadingHTTPServer:
    """Build (not start) an HTTP server around ``ModelServer`` ``server``;
    port 0 binds an ephemeral port (``httpd.server_address[1]``)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = request_timeout_s

        def handle_one_request(self):
            try:
                super().handle_one_request()
            except TimeoutError:   # a stalled client
                self.close_connection = True

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, payload: Any) -> None:
            self._reply_text(code, json.dumps(payload, default=str),
                             "application/json")

        def _reply_text(self, code: int, text: str,
                        content_type: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> Optional[Any]:
            try:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                return None

        def do_GET(self):
            url = urlsplit(self.path)
            path = url.path
            if path == "/healthz":
                ok, doc = healthz_doc(server)
                self._reply(200 if ok else 503, doc)
            elif path == "/metrics":
                fmt = (parse_qs(url.query).get("format") or ["json"])[0]
                if fmt == "prometheus":
                    from ..obs.prometheus import prometheus_text

                    self._reply_text(
                        200, prometheus_text(server.snapshot()),
                        "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._reply(200, server.snapshot())
            else:
                self._reply(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            doc = self._read_json()
            if not isinstance(doc, dict):
                return self._reply(400, {"error": "invalid JSON body"})
            if self.path == "/score":
                rows = doc.get("rows")
                if not isinstance(rows, list):
                    return self._reply(
                        400, {"error": "body must be {'rows': [...]}"})
                try:
                    results = server.score(rows,
                                           timeout_ms=doc.get("timeoutMs"))
                except TypeError as exc:   # non-dict rows
                    return self._reply(400, {"error": str(exc)})
                except Exception as exc:   # the batch's scoring failed
                    return self._reply(500, {
                        "error": f"{type(exc).__name__}: {exc}"})
                scores = [r.to_json() if isinstance(r, ShedResult) else r
                          for r in results]
                shed = any(isinstance(r, ShedResult) for r in results)
                self._reply(503 if shed else 200, {"scores": scores})
            elif self.path == "/swap":
                if not doc.get("path"):
                    return self._reply(
                        400, {"error": "body must be {'path': ...}"})
                try:
                    entry = server.swap(doc["path"])
                except Exception as exc:
                    return self._reply(500, {"error": str(exc)})
                self._reply(200, {"swapped": entry.describe()})
            elif self.path == "/drain":
                server.begin_drain()
                self._reply(200, {"draining": True})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

    class _Server(ThreadingHTTPServer):
        # the stdlib backlog of 5 refuses a connect burst at the socket
        request_queue_size = 128
        daemon_threads = True

    return _Server((host, port), Handler)


def serve_forever(server, host: str = "127.0.0.1", port: int = 8080,
                  background: bool = False,
                  request_timeout_s: float = 30.0):
    """Serve HTTP; with ``background`` on a daemon thread, returning the
    httpd (call ``shutdown()`` and ``server_close()`` to stop it)."""
    httpd = make_http_server(server, host, port,
                             request_timeout_s=request_timeout_s)
    if background:
        threading.Thread(target=httpd.serve_forever, name="op-serving-http",
                         daemon=True).start()
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return httpd
