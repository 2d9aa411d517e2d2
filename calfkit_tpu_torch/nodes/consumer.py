"""Consumer nodes: observers with no seams, no fault rail, no replies.

The port's own copy of ``calfkit_tpu_torch.nodes.consumer``: a consumer projects
deliveries into a read-only context and floors every error at a single
ERROR log.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.models._wire import ValidationError
from calfkit_tpu_torch.mesh.transport import Record
from calfkit_tpu_torch.models.session_context import Envelope
from calfkit_tpu_torch.nodes.base import BaseNodeDef

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ConsumerContext:
    """Read-only projection of one observed delivery."""

    topic: str
    headers: dict[str, str]
    envelope: Envelope | None
    raw: bytes
    correlation_id: str | None
    task_id: str | None
    emitter: str | None


class ConsumerNode(BaseNodeDef):
    kind = "consumer"

    def __init__(
        self,
        fn: Callable[[ConsumerContext], Any],
        *,
        name: str,
        topics: list[str],
    ):
        super().__init__(name)
        self.fn = fn
        self._topics = [protocol.require_topic_safe(t) for t in topics]

    def input_topics(self) -> list[str]:
        return list(self._topics)

    def return_topic(self) -> str:
        return protocol.require_topic_safe(f"consumer.{self.name}.private.return")

    # overriding the whole pipeline: consumers have no kernel stages
    async def _handle_delivery(self, record: Record) -> None:
        if record.headers.get(protocol.HDR_KIND) == "cancel":
            # control record, not observable traffic: fan out to the
            # in-process cancellation targets exactly like the kernel
            # path.  Without this short-circuit the dispatcher's EXPRESS
            # cancel delivery would run the user's consumer fn INLINE on
            # the intake pull task — head-of-line blocking the very path
            # built to avoid it, with a spurious envelope=None delivery.
            self._handle_cancel(record.headers)
            return
        envelope: Envelope | None = None
        if protocol.is_envelope(record.headers):
            try:
                envelope = Envelope.from_wire(record.value)
            except (ValidationError, ValueError):
                envelope = None  # consumers also observe undecodable traffic
        ctx = ConsumerContext(
            topic=record.topic,
            headers=dict(record.headers),
            envelope=envelope,
            raw=record.value,
            correlation_id=record.headers.get(protocol.HDR_CORRELATION),
            task_id=record.headers.get(protocol.HDR_TASK),
            emitter=record.headers.get(protocol.HDR_EMITTER),
        )
        try:
            result = self.fn(ctx)
            if hasattr(result, "__await__"):
                await result
        except Exception:  # noqa: BLE001 - the single ERROR floor
            logger.exception(
                "[%s] consumer body failed on %s", self.node_id, record.topic
            )


def consumer(
    *, topics: list[str], name: str | None = None
) -> Callable[[Callable[[ConsumerContext], Any]], ConsumerNode]:
    """Decorator: ``@consumer(topics=[...])`` → a deployable observer node."""

    def build(fn: Callable[[ConsumerContext], Any]) -> ConsumerNode:
        return ConsumerNode(fn, name=name or fn.__name__, topics=topics)

    return build
