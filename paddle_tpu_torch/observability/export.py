"""Exporters: Prometheus text exposition, JSON snapshot, /metrics HTTP.

The registry is the source of truth (`observability.metrics`); this
module renders it.  Formats:

* `prometheus_text(registry)` — text exposition format 0.0.4 (the
  de-facto scrape format): `# HELP` / `# TYPE` headers, label escaping
  (backslash, double-quote, newline), histograms as CUMULATIVE
  `_bucket{le="..."}` series plus `_sum` / `_count`.  Metric names are
  sanitized to the Prometheus charset (dots -> underscores), label names
  likewise.
* `json_snapshot(registry)` — one JSON-able dict (name -> series list)
  with the full back-compat summary per series (histograms keep the
  p50/p95/p99 the `/stats` endpoint always had).  Safe to call under
  concurrent mutation: each family is read under its own lock.
* `serve_metrics_http(...)` — a standalone threaded HTTP endpoint
  (GET /metrics -> text exposition, GET /metrics.json -> snapshot),
  the same stdlib plumbing the serving front end uses;
  `InferenceServer.serve_http` also answers /metrics directly.
"""

from __future__ import annotations

import json
import math
import re

from .metrics import Counter, Gauge, Histogram, default_registry

__all__ = ["prometheus_text", "json_snapshot", "serve_metrics_http"]

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")


def sanitize_name(name):
    """Prometheus metric-name charset; dots and dashes -> underscores."""
    if _NAME_OK.match(name):
        return name
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not re.match(r"[a-zA-Z_:]", out[0]):
        out = "_" + out
    return out


def sanitize_label_name(name):
    if _LABEL_OK.match(name):
        return name
    out = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if not out or not re.match(r"[a-zA-Z_]", out[0]):
        out = "_" + out
    return out


def escape_label_value(v):
    """Exposition-format escaping: backslash, double quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(text):
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_text(labelnames, labelvalues, extra=()):
    pairs = [(sanitize_label_name(n), escape_label_value(v))
             for n, v in zip(labelnames, labelvalues)]
    pairs += [(n, escape_label_value(v)) for n, v in extra]
    if not pairs:
        return ""
    return "{%s}" % ",".join('%s="%s"' % p for p in pairs)


def prometheus_text(registry=None):
    """Render every family in the registry as text exposition 0.0.4."""
    registry = registry or default_registry()
    lines = []
    for fam in registry.collect():
        name = sanitize_name(fam.name)
        lines.append("# HELP %s %s" % (name, escape_help(fam.help or "")))
        lines.append("# TYPE %s %s" % (name, fam.type))
        for labelvalues, child in fam._series():
            if isinstance(fam, Counter):
                lines.append("%s%s %s" % (
                    name, _labels_text(fam.labelnames, labelvalues),
                    _fmt_value(child._n)))
            elif isinstance(fam, Gauge):
                lines.append("%s%s %s" % (
                    name, _labels_text(fam.labelnames, labelvalues),
                    _fmt_value(child.value)))
            elif isinstance(fam, Histogram):
                with child._lock:
                    cum, acc = [], 0
                    for ub, n in zip(child.buckets, child._bucket_counts):
                        acc += n
                        cum.append((ub, acc))
                    total, count = child.sum, child.count
                for ub, c in cum:
                    le = "+Inf" if ub == float("inf") else _fmt_value(ub)
                    lines.append("%s_bucket%s %d" % (
                        name,
                        _labels_text(fam.labelnames, labelvalues,
                                     extra=(("le", le),)),
                        c))
                lt = _labels_text(fam.labelnames, labelvalues)
                lines.append("%s_sum%s %s" % (name, lt, _fmt_value(total)))
                lines.append("%s_count%s %d" % (name, lt, count))
            else:  # untyped: best-effort value
                lines.append("%s%s %s" % (
                    name, _labels_text(fam.labelnames, labelvalues),
                    _fmt_value(getattr(child, "value", float("nan")))))
    return "\n".join(lines) + ("\n" if lines else "")


def json_snapshot(registry=None):
    """{name: {"type", "help", "labelnames", "series": [...]}} — each
    series carries its labels and the full summary dict."""
    registry = registry or default_registry()
    out = {}
    for fam in registry.collect():
        series = []
        for labelvalues, child in fam._series():
            entry = {"labels": dict(zip(fam.labelnames, labelvalues))}
            if isinstance(fam, Histogram):
                s = child.summary()
                s.pop("name", None)
                entry.update(s)
                entry["buckets"] = [
                    ["+Inf" if ub == float("inf") else ub, c]
                    for ub, c in child.cumulative_buckets()
                ]
            else:
                entry["value"] = child.value if not isinstance(fam, Gauge) \
                    else _finite_or_none(child.value)
            series.append(entry)
        out[fam.name] = {
            "type": fam.type,
            "help": fam.help or "",
            "labelnames": list(fam.labelnames),
            "series": series,
        }
    return out


def _finite_or_none(v):
    try:
        return v if math.isfinite(v) else None
    except TypeError:
        return None


def serve_metrics_http(registry=None, host="127.0.0.1", port=9464,
                       block=False):
    """Threaded stdlib HTTP endpoint: GET /metrics (Prometheus text),
    GET /metrics.json (snapshot), GET /health.  Returns the HTTPServer;
    daemon-threaded when block=False (call .shutdown() to stop)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    registry = registry or default_registry()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, prometheus_text(registry),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/metrics.json":
                self._send(200, json.dumps(json_snapshot(registry)),
                           "application/json")
            elif self.path == "/health":
                self._send(200, '{"status": "ok"}', "application/json")
            else:
                self._send(404, '{"error": "unknown path"}',
                           "application/json")

    httpd = ThreadingHTTPServer((host, port), Handler)
    if block:
        httpd.serve_forever()
    else:
        import threading

        t = threading.Thread(target=httpd.serve_forever, daemon=True,
                             name="metrics-http")
        t.start()
    return httpd
