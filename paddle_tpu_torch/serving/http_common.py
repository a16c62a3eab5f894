"""HTTP plumbing of the serving fronts: JSON response helpers and the
shared GET plane (/healthz, /readyz, /stats, /metrics).

Counterpart of the two pieces of `paddle_tpu.inference.http_common`
that the generation front uses."""

from __future__ import annotations

import json

__all__ = ["JsonHandlerMixin", "standard_get_plane"]


class JsonHandlerMixin:
    """Mix into a BaseHTTPRequestHandler: JSON send/parse helpers."""

    def _send(self, code, payload, headers=()):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code, text, ctype):
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        msg = json.loads(raw or b"{}")
        if not isinstance(msg, dict):
            raise ValueError("body must be a JSON object")
        return msg


def standard_get_plane(handler, path, *, ready_fn, stats_fn, registry,
                       not_ready_reason="not ready"):
    """Serve the shared GET plane (/healthz, /readyz, /stats, /metrics)
    on a `JsonHandlerMixin` handler; returns True when ``path`` was
    handled."""
    if path == "/healthz":
        handler._send(200, {"status": "ok"})
    elif path == "/readyz":
        if ready_fn():
            handler._send(200, {"ready": True})
        else:
            handler._send(503, {"ready": False,
                                "reason": not_ready_reason})
    elif path == "/stats":
        handler._send(200, stats_fn())
    elif path == "/metrics":
        from ..observability.export import prometheus_text

        handler._send_text(200, prometheus_text(registry),
                           "text/plain; version=0.0.4; charset=utf-8")
    else:
        return False
    return True
