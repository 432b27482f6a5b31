"""Pull-based live metrics: Prometheus text-format exposition of the
registry, served from a stdlib HTTP thread (the port of
`pytorch_ddp_mnist_tpu/telemetry/prom.py`; the same names, format and
endpoints).

  * pure stdlib (`http.server` on a daemon thread);
  * read-only: a scrape renders from the same live metric objects
    `snapshot()` reads, so a scraper costs the training loop nothing.

Name mapping: registry names pass through with every non-`[a-zA-Z0-9_:]`
character replaced by `_` (`health.worst_severity_level` ->
`health_worst_severity_level`). Counters render as `counter`, gauges as
`gauge` (None-valued gauges are omitted), histograms as a `summary`
quantile series plus `_sum`/`_count` and a `_max` gauge.

Endpoints: `/metrics` (text/plain; version=0.0.4) and `/healthz` (JSON:
the `health_summary` verdict, 200 while nothing fatal fired, 503 after; a
serve replica fleet with zero healthy replicas is also 503).
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import MetricsRegistry, get_registry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def metric_name(name: str) -> str:
    """Registry name -> Prometheus metric name (one rule, no prefixes)."""
    out = _NAME_RE.sub("_", str(name))
    return ("_" + out) if out[:1].isdigit() else out


def _fmt(v) -> str:
    # Prometheus floats: repr keeps full precision; ints stay ints
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """The whole registry as Prometheus text exposition format (0.0.4).
    Deterministic: metrics sort by name, so the output is golden-testable
    and diffs between scrapes are semantic."""
    reg = registry if registry is not None else get_registry()
    snap = reg.snapshot()
    lines: "list[str]" = []
    for name, value in sorted(snap["counters"].items()):
        m = metric_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(value)}")
    for name, value in sorted(snap["gauges"].items()):
        if value is None:  # dead provider / never set: absent beats lying
            continue
        m = metric_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(value)}")
    for name, h in sorted(snap["histograms"].items()):
        m = metric_name(name)
        lines.append(f"# TYPE {m} summary")
        for label, key in _QUANTILES:
            lines.append(f'{m}{{quantile="{label}"}} {_fmt(h[key])}')
        lines.append(f"{m}_sum {_fmt(h['mean'] * h['n'])}")
        lines.append(f"{m}_count {_fmt(h['n'])}")
        lines.append(f"# TYPE {m}_max gauge")
        lines.append(f"{m}_max {_fmt(h['max'])}")
    return "\n".join(lines) + "\n"


class _MetricsHandler(BaseHTTPRequestHandler):
    # class attrs bound per-server by start_metrics_server
    registry: MetricsRegistry = None  # type: ignore[assignment]

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler's spelling
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = render_prometheus(self.registry).encode()
            self._reply(200, body,
                        "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            from .health import health_summary
            verdict = health_summary(self.registry)
            # fatal watchdog OR a replica fleet with nothing healthy left:
            # both mean "stop sending traffic here" (a merely DEGRADED
            # fleet stays 200 — it is still serving)
            fleet = verdict.get("fleet")
            dead_fleet = fleet is not None and fleet["healthy"] == 0
            status = (503 if verdict["worst_severity"] == "fatal"
                      or dead_fleet else 200)
            self._reply(status, (json.dumps(verdict) + "\n").encode(),
                        "application/json")
        else:
            self._reply(404, b"not found: try /metrics or /healthz\n",
                        "text/plain")

    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        pass


def start_metrics_server(port: int, *,
                         registry: Optional[MetricsRegistry] = None,
                         host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Bind the /metrics endpoint on `host:port` (0 = ephemeral) and serve
    it from a daemon thread. Returns the server; `.server_address[1]` is
    the bound port, `.shutdown()` stops it (the thread is daemonic, so a
    crashed run never hangs on it either)."""
    reg = registry if registry is not None else get_registry()

    class Handler(_MetricsHandler):
        pass

    Handler.registry = reg
    server = ThreadingHTTPServer((host, int(port)), Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="pdmt-metrics", daemon=True)
    thread.start()
    return server
