"""Wire body models: everything that travels inside a mesh record.

The port's own copies of the JAX package's models of the same names, as
wire dataclasses (:mod:`calfkit_tpu_torch.models._wire`) with no transport
or node dependencies.  Their JSON is the JAX package's: either package
reads the other's records.
"""

from calfkit_tpu_torch.models.payload import (
    ContentPart,
    DataPart,
    FilePart,
    TextPart,
    ToolCallPart,
    is_retry,
    render_parts_as_text,
    retry_text_part,
    text_parts,
)
from calfkit_tpu_torch.models.messages import (
    ModelMessage,
    ModelRequest,
    ModelResponse,
    RetryPart,
    SystemPart,
    TextOutput,
    ThinkingOutput,
    ToolCallOutput,
    ToolReturnPart,
    Usage,
    UserPart,
    user_message,
)
from calfkit_tpu_torch.models.marker import CallMarker, Marker, ToolCallMarker
from calfkit_tpu_torch.models.error_report import ErrorReport, ExceptionInfo, FaultTypes
from calfkit_tpu_torch.models.state import State
from calfkit_tpu_torch.models.reply import FaultMessage, Reply, ReturnMessage
from calfkit_tpu_torch.models.session_context import (
    CallFrame,
    Envelope,
    SessionContext,
    WorkflowState,
)
from calfkit_tpu_torch.models.actions import Call, Next, NodeResult, ReturnCall, TailCall
from calfkit_tpu_torch.models.step import (
    AgentMessageStep,
    HandoffStep,
    InferenceStep,
    Step,
    StepEvent,
    StepMessage,
    ThinkingStep,
    TokenStep,
    ToolCallStep,
    ToolResultStep,
)
from calfkit_tpu_torch.models.fanout import (
    EnvelopeSnapshot,
    FanoutOpen,
    FanoutOutcome,
    FanoutState,
    SlotRef,
)
from calfkit_tpu_torch.models.capability import CapabilityRecord, ToolDef, resolve_capability
from calfkit_tpu_torch.models.agents import AgentCard
from calfkit_tpu_torch.models.records import ControlPlaneRecord, ControlPlaneStamp
from calfkit_tpu_torch.models.tool_dispatch import ToolBinding, ToolCallRef
from calfkit_tpu_torch.models.node_result import InvocationResult

__all__ = [
    "AgentCard",
    "AgentMessageStep",
    "Call",
    "CallFrame",
    "CallMarker",
    "CapabilityRecord",
    "ContentPart",
    "ControlPlaneRecord",
    "ControlPlaneStamp",
    "DataPart",
    "Envelope",
    "EnvelopeSnapshot",
    "ErrorReport",
    "ExceptionInfo",
    "FanoutOpen",
    "FanoutOutcome",
    "FanoutState",
    "FaultMessage",
    "FaultTypes",
    "FilePart",
    "HandoffStep",
    "InferenceStep",
    "InvocationResult",
    "Marker",
    "ModelMessage",
    "ModelRequest",
    "ModelResponse",
    "Next",
    "NodeResult",
    "Reply",
    "RetryPart",
    "ReturnCall",
    "ReturnMessage",
    "SessionContext",
    "SlotRef",
    "State",
    "Step",
    "StepEvent",
    "StepMessage",
    "SystemPart",
    "TailCall",
    "TextOutput",
    "TextPart",
    "ThinkingOutput",
    "ThinkingStep",
    "TokenStep",
    "ToolBinding",
    "ToolCallOutput",
    "ToolCallPart",
    "ToolCallRef",
    "ToolCallStep",
    "ToolDef",
    "ToolResultStep",
    "ToolReturnPart",
    "Usage",
    "UserPart",
    "WorkflowState",
    "is_retry",
    "render_parts_as_text",
    "resolve_capability",
    "retry_text_part",
    "text_parts",
    "user_message",
]
