"""The envelope's reply slot: ReturnMessage XOR FaultMessage.

``frame_id`` is the id of the frame the callee unwound to produce this reply;
the caller classifies the reply (pending slot vs fan-out sibling vs stray)
against it before any user code runs (reference: calfkit/models/reply.py:41-82).
``tag`` and ``marker`` are echoed verbatim from the call frame.
"""

from __future__ import annotations

from typing import Literal, Union

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire

from calfkit_tpu_torch.models.error_report import ErrorReport
from calfkit_tpu_torch.models.marker import Marker
from calfkit_tpu_torch.models.payload import ContentPart


@dataclass(kw_only=True)
class ReturnMessage(Wire):
    kind: Literal["return"] = "return"
    parts: list[ContentPart] = field(default_factory=list)
    frame_id: str | None = None
    tag: str | None = None
    marker: Marker | None = None


@dataclass(kw_only=True)
class FaultMessage(Wire):
    kind: Literal["fault"] = "fault"
    report: ErrorReport
    frame_id: str | None = None
    tag: str | None = None
    marker: Marker | None = None


Reply = Union[ReturnMessage, FaultMessage]
