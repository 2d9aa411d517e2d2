"""The one-model-turn runner: the port's own copy of
``calfkit_tpu.engine.turn``.

A turn is exactly ONE model request; any tool calls in the response are
*deferred* — returned to the caller for dispatch over the mesh — never
executed in-process.  Structured output (an ``output_type`` other than
``str``, riding the ``final_result`` output tool with bounded in-turn
retries in the JAX package) is not ported yet (ROADMAP Queue 1):
:func:`run_turn` refuses it with
:class:`~calfkit_tpu_torch.engine.schema.ToolSchemaError`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from calfkit_tpu_torch.engine.model_client import (
    ModelClient,
    ModelRequestParameters,
    ModelSettings,
)
from calfkit_tpu_torch.engine.schema import output_tool_def
from calfkit_tpu_torch.models.capability import ToolDef
from calfkit_tpu_torch.exceptions import NodeFaultError, error_type_for
from calfkit_tpu_torch.models.error_report import ErrorReport, FaultTypes, safe_str
from calfkit_tpu_torch.models.messages import (
    ModelMessage,
    ModelResponse,
    ToolCallOutput,
    Usage,
)

FINAL_RESULT_TOOL = "final_result"

# vendor/in-tree phrasings of "the prompt does not fit the model":
# JaxLocalModelClient ("exceeds max_seq_len"/"exceeds long_max_prompt"),
# OpenAI ("maximum context length"), Anthropic ("prompt is too long"),
# generic "context window"
_CONTEXT_OVERFLOW_MARKERS = (
    "context window", "context length", "context_length",
    "prompt is too long", "exceeds max_seq_len", "exceeds long_max_prompt",
)

# providers' STRUCTURED error codes for "prompt does not fit"
_CONTEXT_OVERFLOW_CODES = frozenset({
    "context_length_exceeded",        # OpenAI error.code
    "context_window_exceeded",
})

# GENERIC request-rejected spellings (Anthropic, OpenAI-compatible proxies/
# SGLang/vLLM) that say nothing about WHY — these fall through to the
# message heuristic.  Any other specific code is authoritative non-overflow.
_GENERIC_ERROR_CODES = frozenset({
    "invalid_request_error", "badrequesterror", "bad_request",
    "invalid_request", "bad_request_error",
})


def _is_context_overflow(exc: BaseException, message: str) -> bool:
    """Classify by the provider's structured error fields first; substring
    matching is only a fallback (the raw text can include an echoed HTTP
    body, and user text saying 'context window' must not flip the fault
    type).  A SPECIFIC structured code that is not an overflow code is
    authoritative non-overflow; generic request-rejected codes (Anthropic's
    overflow spelling carries no dedicated code; compat backends use bare
    BadRequestError) fall through to the provider's own message field."""
    code = getattr(exc, "error_code", None)
    if isinstance(code, str):
        lc = code.lower()
        # exact overflow codes, plus proxy class-name spellings like
        # ContextWindowExceededError
        if lc in _CONTEXT_OVERFLOW_CODES or (
            "context" in lc and ("exceed" in lc or "length" in lc)
        ):
            return True
        if lc not in _GENERIC_ERROR_CODES:
            return False
    api_message = getattr(exc, "error_message", None)
    if isinstance(api_message, str):
        lowered = api_message.lower()
    else:
        lowered = message.lower()
    return any(marker in lowered for marker in _CONTEXT_OVERFLOW_MARKERS)


@dataclass
class TurnOutcome:
    """What one model turn produced.

    Exactly one of:
    - ``tool_calls`` non-empty → the caller dispatches them over the mesh;
    - otherwise ``output`` is the final (possibly structured) result.
    ``new_messages`` are the wire-state messages to commit either way.
    """

    new_messages: list[ModelMessage]
    response: ModelResponse
    usage: Usage
    tool_calls: list[ToolCallOutput] = field(default_factory=list)
    output: Any = None

    @property
    def is_final(self) -> bool:
        return not self.tool_calls


async def run_turn(
    model: ModelClient,
    messages: list[ModelMessage],
    *,
    tool_defs: list[ToolDef] | None = None,
    output_type: type = str,
    settings: ModelSettings | None = None,
    author: str | None = None,
    max_output_retries: int = 2,
) -> TurnOutcome:
    """Run one model turn against ``messages`` (already including any staged
    user prompt / tool returns as the final request).  ``output_type`` must
    be ``str``; ``max_output_retries`` bounds the structured-output retries
    the JAX package runs and is unused until structured output is ported."""
    if output_type is not str:
        output_tool_def(output_type)  # raises ToolSchemaError
    params = ModelRequestParameters(
        tool_defs=list(tool_defs or []),
        output_tool=None,
        allow_text_output=True,
    )
    try:
        response = await model.request(list(messages), settings, params)
    except NodeFaultError:
        raise
    except Exception as exc:
        # a backend failure is a MODEL fault, not a generic node error:
        # the typed report lets callers/seams match on mesh.model_error
        # (context-window overflows keep their own narrower type, and
        # exceptions in the authoritative x-mesh-error-type table —
        # EngineOverloadedError above all — keep THEIR code: an engine
        # shed crossing this wrap as mesh.model_error would hide a
        # retriable overload as a model bug).
        # safe_str: a hostile __str__ must not defeat the typed mint.
        message = safe_str(exc)
        error_type = (
            FaultTypes.CONTEXT_WINDOW_EXCEEDED
            if _is_context_overflow(exc, message)
            else error_type_for(exc) or FaultTypes.MODEL_ERROR
        )
        raise NodeFaultError(
            ErrorReport.build_safe(
                error_type,
                f"model request failed ({model.model_name}): "
                f"{type(exc).__name__}: {message}",
                exc=exc,
            )
        ) from exc
    if author and response.author is None:
        response = response.model_copy(update={"author": author})
    usage = Usage() + response.usage

    # tool calls defer to the mesh; a stray final_result alongside them is
    # ignored this turn (the model will be re-asked)
    dispatch_calls = [c for c in response.tool_calls() if c.tool_name != FINAL_RESULT_TOOL]
    if dispatch_calls:
        return TurnOutcome(
            new_messages=[response],
            response=response,
            usage=usage,
            tool_calls=dispatch_calls,
        )
    return TurnOutcome(
        new_messages=[response],
        response=response,
        usage=usage,
        output=response.text(),
    )
