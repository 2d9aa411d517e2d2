"""Tracing: contexts, spans and the process tracer.

The port's own copy of ``calfkit_tpu.observability.trace`` (same names,
same behaviour).  A :class:`TraceContext` (trace_id / span_id /
parent_span_id) travels with a call; :data:`current_context` carries it
to in-process children, so the model client opens ``engine.generate``
with ``engine.prefill`` and ``engine.decode`` children under the caller's
span with no plumbing.  Finished spans are
:class:`~calfkit_tpu_torch.models.records.SpanRecord` wire records.  Every
export lands in a bounded in-process ring; while a ``collect_spans`` sink
is installed, exports are also appended there, and the hop that owns a
transport publishes them to the compacted ``mesh.traces`` topic
(:func:`publish_spans_soon`).

Failure policy: tracing is telemetry.  ``start_span`` / ``end`` /
``export`` never raise; a broken exporter loses spans, not requests.
"""

from __future__ import annotations

import time
import uuid
from collections import deque
from contextvars import ContextVar, Token
from dataclasses import dataclass
from typing import Any, Iterable

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.models.records import SpanRecord

__all__ = [
    "SpanRecord",
    "TraceContext",
    "Span",
    "Tracer",
    "TRACER",
    "current_context",
    "collect_spans",
    "release_spans",
]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """What travels in headers: enough to parent the next span."""

    trace_id: str
    span_id: str
    parent_span_id: str | None = None

    def headers(self) -> dict[str, str]:
        return {
            protocol.HDR_TRACE: self.trace_id,
            protocol.HDR_SPAN: self.span_id,
        }

    @classmethod
    def from_headers(cls, headers: dict[str, str]) -> "TraceContext | None":
        """Decode a remote context; ``None`` when the record carries no
        trace (consumers must tolerate missing headers)."""
        trace_id = headers.get(protocol.HDR_TRACE)
        if not trace_id:
            return None
        return cls(
            trace_id=trace_id,
            span_id=headers.get(protocol.HDR_SPAN) or "",
        )


# the active context for THIS task tree: set by the node kernel around a
# delivery (and by the agent around a model turn) so in-process children —
# the inference engine above all — parent correctly without any plumbing
current_context: ContextVar[TraceContext | None] = ContextVar(
    "calfkit_trace_context", default=None
)

# hop-local span sink: spans finished while a sink is installed are
# ALSO appended there, so the hop's owner can publish them to the mesh
_span_sink: ContextVar["list[SpanRecord] | None"] = ContextVar(
    "calfkit_trace_sink", default=None
)


def collect_spans() -> "tuple[list[SpanRecord], Token]":
    """Install a fresh hop-local sink; returns (sink, reset token)."""
    sink: list[SpanRecord] = []
    return sink, _span_sink.set(sink)


def release_spans(token: Token) -> None:
    try:
        _span_sink.reset(token)
    except Exception:  # noqa: BLE001 - cross-context reset; never fault the hop
        pass


class Span:
    """One timed operation; ``end()`` is idempotent and never raises."""

    __slots__ = (
        "name", "kind", "emitter", "context", "attrs", "status",
        "start_s", "_t0", "_tracer", "_ended",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        *,
        context: TraceContext,
        kind: str = "internal",
        emitter: str = "",
        attrs: dict[str, Any] | None = None,
    ):
        self._tracer = tracer
        self.name = name
        self.kind = kind
        self.emitter = emitter
        self.context = context
        self.attrs: dict[str, Any] = dict(attrs or {})
        self.status = "ok"
        self.start_s = time.time()
        self._t0 = time.perf_counter()
        self._ended = False

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def end(self, status: str | None = None, **attrs: Any) -> SpanRecord | None:
        """Finish + export; returns the record (None on double-end)."""
        if self._ended:
            return None
        self._ended = True
        try:
            if status is not None:
                self.status = status
            self.attrs.update(attrs)
            record = SpanRecord(
                trace_id=self.context.trace_id,
                span_id=self.context.span_id,
                parent_span_id=self.context.parent_span_id,
                name=self.name,
                kind=self.kind,
                emitter=self.emitter,
                start_s=self.start_s,
                duration_ms=(time.perf_counter() - self._t0) * 1000.0,
                status=self.status,
                attrs=self.attrs,
            )
            self._tracer.export(record)
            return record
        except Exception:  # noqa: BLE001 - tracing never faults the caller
            return None


class Tracer:
    """Process tracer: mints spans, keeps the bounded ring of finished
    records (the zero-broker fallback), and fans exports into the active
    hop sink when one is installed."""

    def __init__(self, ring_size: int = 2048):
        self._ring: deque[SpanRecord] = deque(maxlen=ring_size)
        self.enabled = True

    def set_enabled(self, on: bool) -> None:
        self.enabled = bool(on)

    def start_span(
        self,
        name: str,
        *,
        parent: TraceContext | None = None,
        trace_id: str | None = None,
        kind: str = "internal",
        emitter: str = "",
        attrs: dict[str, Any] | None = None,
    ) -> Span:
        """New span.  With ``parent``, the child joins that trace; without,
        a new trace is minted (``trace_id`` pins it — the client passes the
        correlation id so trace lookup needs no extra bookkeeping)."""
        if parent is not None:
            context = TraceContext(
                trace_id=parent.trace_id,
                span_id=new_span_id(),
                parent_span_id=parent.span_id or None,
            )
        else:
            context = TraceContext(
                trace_id=trace_id or uuid.uuid4().hex,
                span_id=new_span_id(),
            )
        return Span(
            self, name, context=context, kind=kind, emitter=emitter, attrs=attrs
        )

    def export(self, record: SpanRecord) -> None:
        if not self.enabled:
            return
        try:
            self._ring.append(record)
            sink = _span_sink.get()
            if sink is not None:
                sink.append(record)
        except Exception:  # noqa: BLE001 - export is best-effort by contract
            pass

    def finished(self, trace_id: str | None = None) -> list[SpanRecord]:
        """Ring-buffer contents (optionally one trace), oldest first."""
        records: Iterable[SpanRecord] = list(self._ring)
        if trace_id is not None:
            records = [r for r in records if r.trace_id == trace_id]
        return list(records)

    def clear(self) -> None:
        self._ring.clear()


TRACER = Tracer()



def publish_spans_soon(
    publish: Any,
    records: "list[SpanRecord]",
    tasks: "set[Any]",
    *,
    on_error: Any = None,
) -> None:
    """Fire-and-forget export of finished spans to ``mesh.traces`` via an
    async ``publish(topic, value, key=..., headers=...)`` callable — the
    one copy of the export pattern the client and the node kernel share.
    The export rides a task held in ``tasks`` until done (GC safety).
    Strictly fail-open: a failed export degrades to ring-buffer-only
    visibility; ``on_error`` (if given) is called once with the exception."""
    if not records:
        return

    async def export() -> None:
        try:
            for record in records:
                await publish(
                    protocol.TRACES_TOPIC,
                    record.to_wire(),
                    key=record.span_key().encode("utf-8"),
                    headers={protocol.HDR_WIRE: "span"},
                )
        except Exception as exc:  # noqa: BLE001 - telemetry never faults
            if on_error is not None:
                try:
                    on_error(exc)
                except Exception:  # noqa: BLE001
                    pass

    try:
        import asyncio

        task = asyncio.get_running_loop().create_task(export())
        tasks.add(task)  # hold a ref until done (GC safety)
        task.add_done_callback(tasks.discard)
    except Exception:  # noqa: BLE001 - no loop / shutting down: ring only
        pass
