"""HTTP scrape surface: /metrics, /health, /traces, /timeseries,
/hostprof, /flightrec.

Reference: the Go server mounts tally's prometheus reporter plus a
health endpoint on every role's HTTP port. Here one tiny stdlib HTTP
server serves the same probes over any MetricsRegistry/Tracer pair;
rpc/server.ServiceHost mounts it next to the wire port, and
Onebox.scrape_server() exposes the in-process cluster the same way.

  GET /metrics    → text/plain prometheus exposition (registry.to_prometheus)
  GET /health     → application/json from the owner's health_fn
  GET /traces     → application/json finished spans grouped by trace_id
  GET /timeseries → application/json ring-buffer windows (timeseries_fn)
  GET /hostprof   → application/json profiler rollup (hostprof_fn)
  GET /flightrec  → application/json flight-recorder snapshot (flightrec_fn)

The three telemetry endpoints take provider callables rather than the
objects themselves so the owner controls the document shape (ServiceHost
bundles sampler windows + burn doc; Onebox serves the box-wide sampler)
and a host that runs with telemetry disabled can simply not pass them —
the paths then 404 like any other unknown route.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple


class ObservabilityHTTPServer:
    """A started-on-demand scrape server over one registry (+ optional
    tracer). Bind port 0 for an ephemeral port (tests); `port` carries
    the bound value either way."""

    def __init__(self, registry, health_fn: Optional[Callable[[], Dict]] = None,
                 tracer=None,
                 address: Tuple[str, int] = ("127.0.0.1", 0),
                 timeseries_fn: Optional[Callable[[], Dict]] = None,
                 hostprof_fn: Optional[Callable[[], Dict]] = None,
                 flightrec_fn: Optional[Callable[[], Dict]] = None) -> None:
        self.registry = registry
        self.health_fn = health_fn
        self.tracer = tracer
        self.timeseries_fn = timeseries_fn
        self.hostprof_fn = hostprof_fn
        self.flightrec_fn = flightrec_fn
        owner = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:
                pass  # scrape traffic must not spam the host's stderr

            def _reply(self, status: int, content_type: str,
                       body: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, doc) -> None:
                self._reply(200, "application/json",
                            json.dumps(doc, default=str).encode())

            def do_GET(self) -> None:
                # name the handler thread so hostprof attributes scrape
                # service time instead of lumping it under "other"
                threading.current_thread().name = "cadence-scrape"
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._reply(200,
                                    "text/plain; version=0.0.4; charset=utf-8",
                                    owner.registry.to_prometheus().encode())
                    elif path == "/health":
                        health = (owner.health_fn()
                                  if owner.health_fn else {"status": "ok"})
                        self._reply_json(health)
                    elif path == "/traces" and owner.tracer is not None:
                        traces = {
                            tid: [s.to_dict() for s in spans]
                            for tid, spans in owner.tracer.traces().items()}
                        self._reply_json(traces)
                    elif (path == "/timeseries"
                          and owner.timeseries_fn is not None):
                        self._reply_json(owner.timeseries_fn())
                    elif path == "/hostprof" and owner.hostprof_fn is not None:
                        self._reply_json(owner.hostprof_fn())
                    elif (path == "/flightrec"
                          and owner.flightrec_fn is not None):
                        self._reply_json(owner.flightrec_fn())
                    else:
                        self._reply(404, "text/plain", b"not found\n")
                except Exception as exc:
                    try:
                        self._reply(500, "text/plain",
                                    f"{type(exc).__name__}: {exc}\n".encode())
                    except Exception:
                        pass  # peer went away mid-reply

        self._httpd = ThreadingHTTPServer(address, _Handler)
        self._httpd.daemon_threads = True
        self.port: int = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObservabilityHTTPServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="cadence-scrape")
        self._thread.start()
        return self

    def stop(self) -> None:
        # shutdown() waits on an event only serve_forever() sets — calling
        # it on a never-started server would deadlock, so gate on the
        # thread (stop() must be safe from any cleanup path)
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread = None
        self._httpd.server_close()
