"""The message and content-part types of a model turn: the port's own
dataclass copies of the JAX package's types of the same names."""

from calfkit_tpu_torch.models.capability import ToolDef
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
from calfkit_tpu_torch.models.payload import (
    ContentPart,
    DataPart,
    FilePart,
    TextPart,
    ToolCallPart,
    render_parts_as_text,
)

__all__ = [
    "ContentPart",
    "DataPart",
    "FilePart",
    "ModelMessage",
    "ModelRequest",
    "ModelResponse",
    "RetryPart",
    "SystemPart",
    "TextOutput",
    "TextPart",
    "ThinkingOutput",
    "ToolCallOutput",
    "ToolCallPart",
    "ToolDef",
    "ToolReturnPart",
    "Usage",
    "UserPart",
    "render_parts_as_text",
    "user_message",
]
