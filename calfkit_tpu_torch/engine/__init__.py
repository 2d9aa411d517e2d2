"""The agent-turn engine of the port: the model-client contract, the
function-signature → JSON-schema extraction, deterministic test models,
and the one-model-turn runner — the port's own copies of the JAX package's
modules of the same names."""

from calfkit_tpu_torch.engine.model_client import (
    ModelClient,
    ModelRequestParameters,
    ModelSettings,
    ResponseDone,
    ResumeOffset,
    StreamEvent,
    TextDelta,
)
from calfkit_tpu_torch.engine.schema import FunctionSchema, function_schema
from calfkit_tpu_torch.engine.turn import FINAL_RESULT_TOOL, TurnOutcome, run_turn
from calfkit_tpu_torch.engine.testing import (
    EchoModelClient,
    FunctionModelClient,
    TestModelClient,
)

__all__ = [
    "EchoModelClient",
    "FINAL_RESULT_TOOL",
    "FunctionModelClient",
    "FunctionSchema",
    "ModelClient",
    "ModelRequestParameters",
    "ModelSettings",
    "ResponseDone",
    "ResumeOffset",
    "StreamEvent",
    "TestModelClient",
    "TextDelta",
    "TurnOutcome",
    "function_schema",
    "run_turn",
]
