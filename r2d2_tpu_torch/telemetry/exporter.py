"""Stdlib-only HTTP exporter: ``/metrics``, ``/healthz``, ``/statusz``
(port of ``r2d2_tpu/telemetry/exporter.py``, copied whole).

Three endpoint contracts, chosen so stock tooling works unmodified:

- ``GET /metrics`` — the registry in Prometheus text exposition format
  0.0.4 (``Content-Type: text/plain; version=0.0.4; charset=utf-8``);
  point a Prometheus scrape job at it.
- ``GET /healthz`` — JSON liveness verdict from the fabric's own
  signals (supervisor failures, learner heartbeat age vs its stall
  budget, fleet/process health).  HTTP 200 when ``ok`` is true, 503
  otherwise — a load balancer or ``curl -f`` needs no JSON parsing.
- ``GET /statusz`` — full JSON snapshot (registry dump + health + the
  newest log entry): the machine-readable twin of the terminal view.

Trigger routes (``routes=``): the caller may register extra GET paths —
the port's ``train()`` wires ``/alertz`` (the learning-health alert
engine's status), ``/tracez`` (``?steps=N`` arms a fabric-wide capture
window of N train steps) and ``/profilez`` (``?secs=S`` arms a
``torch.profiler`` capture) through this hook; a busy window answers
409.  Dumps land in ``<checkpoint_dir>/telemetry/``.  A route handler receives the flat query-param dict and
returns ``(status_code, json_payload)``.

Anything else is 404.  The server binds loopback by default and is
driven by the caller's loop (:meth:`handle_once` — a bounded
``handle_request`` with the server timeout set), so in ``train()`` it
runs as a normal supervised fabric thread with the fabric's stop
predicate, not a free-running stdlib thread pool.

Port semantics (``cfg.telemetry_port``): ``0`` disables the exporter
entirely (:func:`make_exporter` returns None — the default), ``> 0``
binds that port, ``-1`` binds an OS-assigned ephemeral port (tests,
multi-run hosts); the bound port is always on :attr:`TelemetryExporter.
port` and surfaced in the run's log entries.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qsl

# a trigger route: flat query params in, (status code, JSON payload) out
RouteFn = Callable[[Dict[str, str]], Tuple[int, Dict[str, Any]]]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_CONTENT_TYPE = "application/json; charset=utf-8"


class TelemetryExporter:
    """One bounded-request-at-a-time HTTP scrape endpoint."""

    def __init__(self, registry, health_fn: Callable[[], Dict[str, Any]],
                 status_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 routes: Optional[Dict[str, RouteFn]] = None):
        self.registry = registry
        self.health_fn = health_fn
        self.status_fn = status_fn
        self.routes = dict(routes or {})
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            # scrapes must not spam stderr
            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def do_GET(self):  # noqa: N802 (stdlib handler convention)
                try:
                    exporter._respond(self)
                except (BrokenPipeError, ConnectionResetError):
                    pass       # scraper went away mid-reply; next scrape

        self.server = HTTPServer((host, port), _Handler)
        self.server.timeout = 0.2      # bounds handle_once for stop polls
        self.port = int(self.server.server_address[1])
        self.closed = False

    # ------------------------------------------------------------ serving
    def _respond(self, handler: BaseHTTPRequestHandler) -> None:
        path, _, query = handler.path.partition("?")
        if path in self.routes:
            try:
                code, payload = self.routes[path](dict(parse_qsl(query)))
            except Exception as e:   # a trigger must never kill the loop
                code, payload = 500, dict(error=str(e))
            self._send(handler, code, JSON_CONTENT_TYPE,
                       json.dumps(payload, default=str).encode("utf-8"))
        elif path == "/metrics":
            body = self.registry.render_prometheus().encode("utf-8")
            self._send(handler, 200, PROM_CONTENT_TYPE, body)
        elif path == "/healthz":
            health = self.health_fn()
            code = 200 if health.get("ok") else 503
            self._send(handler, code, JSON_CONTENT_TYPE,
                       json.dumps(health, default=str).encode("utf-8"))
        elif path == "/statusz":
            status = dict(metrics=self.registry.snapshot(),
                          health=self.health_fn())
            if self.status_fn is not None:
                status.update(self.status_fn())
            self._send(handler, 200, JSON_CONTENT_TYPE,
                       json.dumps(status, default=str).encode("utf-8"))
        else:
            self._send(handler, 404, JSON_CONTENT_TYPE,
                       b'{"error": "unknown path"}')

    @staticmethod
    def _send(handler: BaseHTTPRequestHandler, code: int,
              content_type: str, body: bytes) -> None:
        handler.send_response(code)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def handle_once(self) -> None:
        """Serve at most one request, bounded by the server timeout —
        the supervised fabric loop body.  The loop runs until
        :meth:`close` (NOT until the fabric's stop flag): a stalled or
        draining run must stay scrapeable — /healthz going non-OK while
        the learner is wedged is the whole point of the endpoint."""
        self.server.handle_request()

    def close(self) -> None:
        self.closed = True            # flag first: the loop polls it
        self.server.server_close()


def make_exporter(cfg, registry, health_fn, status_fn=None,
                  routes=None) -> Optional[TelemetryExporter]:
    """The config gate: ``telemetry_port == 0`` → disabled (None);
    ``> 0`` → that port; ``-1`` → ephemeral (the bound port is on the
    returned exporter)."""
    if cfg.telemetry_port == 0:
        return None
    return TelemetryExporter(registry, health_fn, status_fn=status_fn,
                             port=max(0, cfg.telemetry_port),
                             routes=routes)
