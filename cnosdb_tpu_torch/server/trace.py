"""Distributed tracing: context propagation and export of the process timeline.

Role-parity with the reference's trace crate (common/trace/src/
global_tracing.rs minitrace + OTLP export, span_ext.rs Span helpers,
http/http_ctx.rs header propagation; consumed by TraceCollectorBatcher
ReaderProxy tskv/src/reader/trace.rs): spans carry (trace_id, span_id,
parent_id, name, tags, start/duration) and propagate across processes via
a `cnos-trace-id` header on both the user HTTP API and the node-to-node
RPC plane. Collection is an in-memory ring per process, queryable through
`GET /debug/traces` — the reference's jaeger-store role collapsed to the
embedded case (OTLP export is a config hook away: the collector
interface takes any sink).

The span, the ring and their clock are the process timeline of
`utils/stages.py` (every `stages.stage()` is a span there); this module
continues a propagated trace, hands the active one on, and exports.
"""
from __future__ import annotations

import threading
from ..utils import lockwatch
from ..utils.stages import (GLOBAL_COLLECTOR, Span, TraceCollector,
                            _current_span, current_span)

TRACE_HEADER = "cnos-trace-id"


def from_headers(headers, name: str) -> Span:
    """Continue a trace propagated over HTTP/RPC: header value is
    `trace_id[:parent_span_id]` (reference http_ctx.rs)."""
    raw = headers.get(TRACE_HEADER, "") if headers else ""
    trace_id = parent = None
    if raw:
        trace_id, _, parent = raw.partition(":")
        parent = parent or None
    return GLOBAL_COLLECTOR.span(name, trace_id=trace_id, parent_id=parent)


def current_trace_header() -> str | None:
    """Outgoing propagation value for the active span, if any."""
    cur = _current_span.get()
    if cur is None:
        return None
    return f"{cur.trace_id}:{cur.span_id}"


class OtlpExporter:
    """Background OTLP/HTTP JSON exporter for this process's own spans
    (reference: minitrace → opentelemetry-otlp in global_tracing.rs:14-60).
    Registers as a collector sink; a daemon thread batches spans and POSTs
    {endpoint}/v1/traces. OTLP/HTTP officially supports the JSON encoding,
    so any stock collector accepts these without protobuf codegen."""

    def __init__(self, endpoint: str, collector: TraceCollector,
                 service_name: str = "cnosdb-tpu", batch_size: int = 256,
                 flush_interval_s: float = 2.0):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self._queue: list[dict] = []
        self._lock = lockwatch.Lock("trace.otlp_queue")
        self._wake = threading.Event()
        self._stop = False
        self.exported = 0
        self.errors = 0
        collector.sinks.append(self._enqueue)
        self._thread = threading.Thread(
            target=self._run, name="otlp-exporter", daemon=True)
        self._thread.start()

    def _enqueue(self, span: dict):
        with self._lock:
            self._queue.append(span)
            if len(self._queue) >= self.batch_size:
                self._wake.set()

    def _run(self):
        while not self._stop:
            self._wake.wait(timeout=self.flush_interval_s)
            self._wake.clear()
            self.flush()

    def flush(self):
        with self._lock:
            batch, self._queue = self._queue, []
        if not batch:
            return
        import json
        import urllib.request

        body = json.dumps(self._to_otlp(batch)).encode()
        req = urllib.request.Request(
            f"{self.endpoint}/v1/traces", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                resp.read()
            self.exported += len(batch)
        except Exception:
            self.errors += 1   # drop the batch; tracing is best-effort

    def _to_otlp(self, batch: list[dict]) -> dict:
        spans = []
        for s in batch:
            attrs = [{"key": str(k),
                      "value": {"stringValue": str(v)}}
                     for k, v in (s.get("tags") or {}).items()]
            span = {
                # OTLP ids are fixed-width hex: 16-byte trace, 8-byte span
                "traceId": s["trace_id"].rjust(32, "0"),
                "spanId": s["span_id"].rjust(16, "0"),
                "name": s["name"],
                "kind": 1,   # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(s["start_ns"]),
                "endTimeUnixNano": str(s["start_ns"] + s["duration_ns"]),
                "attributes": attrs,
            }
            if s.get("parent_id"):
                span["parentSpanId"] = s["parent_id"].rjust(16, "0")
            spans.append(span)
        return {"resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": self.service_name}}]},
            "scopeSpans": [{"scope": {"name": "cnosdb_tpu"},
                            "spans": spans}],
        }]}

    def close(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)
        self.flush()
