"""Tracing: spans with cross-RPC context propagation.

Reference: the Go server wires opentracing through every handler
(common/rpc sets up jaeger; service handlers carry per-request tagged
loggers). Here the same observable contract is reduced to its core: a
span records (trace_id, span_id, parent_id, operation, start, duration,
tags); the tracer keeps a thread-local active-span stack so nested calls
parent naturally; finished spans land in an in-process collector with an
export seam (CADENCE_TPU_TRACE_EXPORT=<dir> appends JSONL per process, so
multi-process traces stitch by trace_id).

Wire propagation: `inject(request)` wraps a wire-frame request as
("traced", carrier, request) when a span is active; the serving side
`extract(request)`s the carrier back into a SpanContext and parents its
server span on it — a frontend→history→matching chain therefore yields
ONE trace whether the hops are in-process calls or real sockets.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


def _new_id() -> str:
    return os.urandom(8).hex()


@dataclass(frozen=True)
class SpanContext:
    """The propagated identity of a span (what crosses process edges)."""

    trace_id: str
    span_id: str

    def to_carrier(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @staticmethod
    def from_carrier(carrier: Any) -> Optional["SpanContext"]:
        """Tolerant decode of a wire carrier (untrusted shape: the wire is
        an internal transport, but a malformed envelope must not take the
        handler down)."""
        if not isinstance(carrier, dict):
            return None
        trace_id, span_id = carrier.get("trace_id"), carrier.get("span_id")
        if not trace_id or not span_id:
            return None
        return SpanContext(str(trace_id)[:64], str(span_id)[:64])


@dataclass
class Span:
    operation: str
    context: SpanContext
    parent_id: Optional[str] = None
    start_time: float = 0.0  # wall clock, seconds since epoch
    duration_s: float = 0.0
    tags: Dict[str, Any] = field(default_factory=dict)
    finished: bool = False

    def set_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.context.trace_id,
            "span_id": self.context.span_id,
            "parent_id": self.parent_id,
            "operation": self.operation,
            "start_time": round(self.start_time, 6),
            "duration_s": round(self.duration_s, 6),
            "tags": self.tags,
            "pid": os.getpid(),
        }


def _file_exporter(directory: str) -> Callable[[Dict[str, Any]], None]:
    """JSONL exporter: one spans-<pid>.jsonl per process, append-per-span —
    the multi-process stitching seam (a real deployment would point the
    same seam at an OTLP/jaeger forwarder)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"spans-{os.getpid()}.jsonl")
    lock = threading.Lock()

    def export(span_dict: Dict[str, Any]) -> None:
        line = json.dumps(span_dict, default=str)
        with lock:
            with open(path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")

    return export


class Tracer:
    """Span factory + in-process collector (thread-safe; the active-span
    stack is thread-local, so concurrent requests never cross-parent)."""

    def __init__(self, max_spans: int = 10_000) -> None:
        self._lock = threading.Lock()
        #: ring buffer: a long-running host keeps the NEWEST spans, so
        #: /traces stays useful after the cap fills (oldest evicted)
        self._finished: deque = deque(maxlen=max_spans)
        self._evicted = 0
        self.max_spans = max_spans
        self._local = threading.local()
        #: export seam: called with span.to_dict() on every finish
        self.exporter: Optional[Callable[[Dict[str, Any]], None]] = None
        export_dir = os.environ.get("CADENCE_TPU_TRACE_EXPORT")
        if export_dir:
            self.exporter = _file_exporter(export_dir)

    # -- active-span bookkeeping (per thread) ------------------------------

    def _stack(self) -> List[SpanContext]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def active_context(self) -> Optional[SpanContext]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- span lifecycle ----------------------------------------------------

    @contextmanager
    def start_span(self, operation: str,
                   child_of: Optional[SpanContext] = None,
                   tags: Optional[Dict[str, Any]] = None):
        """Open a span: explicit `child_of` (an extracted remote context)
        wins; otherwise the thread's active span is the parent; otherwise
        this span roots a new trace."""
        parent = child_of if child_of is not None else self.active_context()
        ctx = SpanContext(
            trace_id=parent.trace_id if parent else _new_id(),
            span_id=_new_id())
        span = Span(operation=operation, context=ctx,
                    parent_id=parent.span_id if parent else None,
                    start_time=time.time(), tags=dict(tags or {}))
        stack = self._stack()
        stack.append(ctx)
        t0 = time.perf_counter()
        try:
            yield span
        except BaseException as exc:
            span.set_tag("error", type(exc).__name__)
            raise
        finally:
            stack.pop()
            span.duration_s = time.perf_counter() - t0
            span.finished = True
            self._collect(span)

    def _collect(self, span: Span) -> None:
        with self._lock:
            if len(self._finished) == self.max_spans:
                self._evicted += 1
            self._finished.append(span)
        if self.exporter is not None:
            try:
                self.exporter(span.to_dict())
            except Exception:
                pass  # export failure must never fail the traced operation

    # -- reads -------------------------------------------------------------

    def finished_spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def traces(self) -> Dict[str, List[Span]]:
        """Finished spans grouped by trace_id, each trace start-ordered."""
        out: Dict[str, List[Span]] = {}
        for span in self.finished_spans():
            out.setdefault(span.context.trace_id, []).append(span)
        for spans in out.values():
            spans.sort(key=lambda s: s.start_time)
        return out

    def reset(self) -> None:
        with self._lock:
            self._finished.clear()
            self._evicted = 0


# -- wire-envelope propagation ----------------------------------------------

def inject(request: Any, tracer: Optional["Tracer"] = None) -> Any:
    """Wrap a wire request with the calling thread's active trace context:
    ("traced", carrier, request). Pass-through when no span is active, so
    untraced traffic keeps the bare envelope."""
    ctx = (tracer or DEFAULT_TRACER).active_context()
    if ctx is None:
        return request
    return ("traced", ctx.to_carrier(), request)


def extract(request: Any) -> Tuple[Optional[SpanContext], Any]:
    """Unwrap a possibly-traced wire request → (context or None, inner)."""
    if (isinstance(request, tuple) and len(request) == 3
            and request[0] == "traced"):
        return SpanContext.from_carrier(request[1]), request[2]
    return None, request


def traced(operation: str):
    """Method decorator: span + latency histogram around a service method.

    The span parents on the thread's active span (or an extracted remote
    context activated by the RPC handler); when the instance carries a
    `metrics` registry, the call's latency is recorded under
    scope=`operation` — one name shared by the trace and the metric, the
    reference's scope-per-API convention (metrics/defs.go)."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            tracer = getattr(self, "tracer", None) or DEFAULT_TRACER
            registry = getattr(self, "metrics", None)
            t0 = time.perf_counter()
            with tracer.start_span(operation):
                try:
                    return fn(self, *args, **kwargs)
                finally:
                    if registry is not None:
                        registry.record(operation, "latency",
                                        time.perf_counter() - t0)
        return wrapper
    return decorate


#: fallback tracer for components constructed without explicit wiring
#: (mirrors metrics.DEFAULT_REGISTRY; tests reset it per test)
DEFAULT_TRACER = Tracer()
