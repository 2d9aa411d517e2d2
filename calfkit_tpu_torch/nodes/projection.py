"""POV projection of multi-agent history + the two message-aware preambles.

Semantics (reference: calfkit/nodes/_projection.py:88-326):

- **Transparent mode** — when the history has no participants other than the
  viewer (no foreign agent turns, at most one named human), pass messages
  through with attribution stripped.  No prefixes ⇒ the prompt prefix (and
  any provider prompt cache) stays stable for single-agent conversations.
- **Multi-participant mode** — the viewer sees its OWN turns verbatim
  (tool-call ids intact: the deferred-results re-entry depends on them);
  other agents' turns appear as attributed user-visible text built from
  their public *surface* (text + final_result / handoff briefing args);
  ordinary foreign tool calls and thinking are internal and dropped.
- Tool returns / retry prompts are kept only when the viewer owns the
  tool_call_id — ownership resolved over the WHOLE history, so a retry
  part referencing a foreign agent's call is stripped even when it arrives
  before/after interleaved turns.
- Human turns are attributed ``<user>`` / ``<user:name>``.

``structured_output_preamble`` / ``step_preamble`` extract the text a hop
*said* alongside what it did (reference: _projection.py:116,139) — from the
hop's FINAL response only, so internal output-retry chatter never surfaces.
"""

from __future__ import annotations

import json
import logging

from calfkit_tpu_torch.models.messages import (
    ModelMessage,
    ModelRequest,
    ModelResponse,
    RetryPart,
    SystemPart,
    TextOutput,
    ToolCallOutput,
    ToolReturnPart,
    UserPart,
)

logger = logging.getLogger(__name__)

_UNKNOWN_AUTHOR = "unknown"


def _is_surfaced_tool(tool_name: str) -> bool:
    """Tools whose ARGS are another agent's public surface: the structured
    final answer and the handoff briefing (its args are the peer's only
    briefing channel)."""
    from calfkit_tpu_torch.engine.turn import FINAL_RESULT_TOOL
    from calfkit_tpu_torch.peers.handoff import HANDOFF_TOOL

    return tool_name in (FINAL_RESULT_TOOL, HANDOFF_TOOL)


def project(history: list[ModelMessage], self_name: str) -> list[ModelMessage]:
    """Re-render ``history`` from ``self_name``'s point of view.

    Pure: returns fresh messages, never mutates the input.
    """
    foreign_agents = {
        m.author
        for m in history
        if isinstance(m, ModelResponse) and m.author and m.author != self_name
    }
    named_humans = {
        p.author
        for m in history
        if isinstance(m, ModelRequest)
        for p in m.parts
        if isinstance(p, UserPart) and p.author
    }
    if not foreign_agents and len(named_humans) < 2:
        return _transparent(history)
    logger.debug(
        "projecting multi-participant POV for %s (%d foreign agents, "
        "%d named humans)",
        self_name, len(foreign_agents), len(named_humans),
    )
    owners = _tool_call_owners(history)
    out: list[ModelMessage] = []
    for message in history:
        if isinstance(message, ModelResponse):
            out.extend(_project_response(message, self_name))
        else:
            out.extend(_project_request(message, self_name, owners))
    return out


# --------------------------------------------------------------------------- #
# transparent pass-through
# --------------------------------------------------------------------------- #


def _transparent(history: list[ModelMessage]) -> list[ModelMessage]:
    out: list[ModelMessage] = []
    for message in history:
        if isinstance(message, ModelResponse):
            out.append(
                message.model_copy(update={"author": None})
                if message.author
                else message
            )
            continue
        if any(isinstance(p, UserPart) and p.author for p in message.parts):
            parts = [
                p.model_copy(update={"author": None})
                if isinstance(p, UserPart) and p.author
                else p
                for p in message.parts
            ]
            out.append(message.model_copy(update={"parts": parts}))
        else:
            out.append(message)
    return out


# --------------------------------------------------------------------------- #
# multi-participant projection
# --------------------------------------------------------------------------- #


def _tool_call_owners(history: list[ModelMessage]) -> dict[str, str]:
    """tool_call_id → authoring agent, resolved over the WHOLE history (a
    foreign retry/return is foreign wherever it appears)."""
    owners: dict[str, str] = {}
    for message in history:
        if isinstance(message, ModelResponse):
            author = message.author or _UNKNOWN_AUTHOR
            for call in message.tool_calls():
                owners[call.tool_call_id] = author
    return owners


def _project_response(
    message: ModelResponse, self_name: str
) -> list[ModelMessage]:
    author = message.author or _UNKNOWN_AUTHOR
    if author == self_name:
        # verbatim (author stripped): in-flight tool-call ids must survive
        # for the deferred-results re-entry
        return [message.model_copy(update={"author": None})]
    surface = _surface(message)
    if not surface:
        return []  # nothing public (e.g. a pure dispatch turn): omitted
    return [
        ModelRequest(
            parts=[UserPart(content=f"<{author}>\n{surface}", author=author)]
        )
    ]


def _surface(message: ModelResponse) -> str:
    """A foreign response's public face: its text plus the canonical JSON of
    surfaced tool args (final answers and handoff briefings)."""
    components: list[str] = []
    for part in message.parts:
        if isinstance(part, TextOutput):
            if part.text:
                components.append(part.text)
        elif isinstance(part, ToolCallOutput) and _is_surfaced_tool(
            part.tool_name
        ):
            if part.args:
                try:
                    components.append(
                        json.dumps(
                            part.args_dict(),
                            separators=(",", ":"),
                            sort_keys=True,
                        )
                    )
                except Exception:  # noqa: BLE001 - degrade, never raise
                    logger.warning(
                        "could not render surfaced args of %s; omitting",
                        part.tool_name, exc_info=True,
                    )
    return "\n".join(components)


def _project_request(
    message: ModelRequest, self_name: str, owners: dict[str, str]
) -> list[ModelMessage]:
    kept: list = []
    for part in message.parts:
        if isinstance(part, (ToolReturnPart, RetryPart)):
            owner = owners.get(part.tool_call_id or "")
            if part.tool_call_id and owner != self_name:
                continue  # a foreign exchange — never show foreign ids
            kept.append(part)
        elif isinstance(part, UserPart):
            kept.append(_attribute_user(part))
        elif isinstance(part, SystemPart):
            kept.append(part)
        else:
            kept.append(part)
    if not kept and not message.instructions:
        return []
    return [message.model_copy(update={"parts": kept})]


def _attribute_user(part: UserPart) -> UserPart:
    prefix = f"<user:{part.author}>" if part.author else "<user>"
    content = part.content
    if isinstance(content, str):
        return UserPart(content=f"{prefix} {content}")
    return part  # structured content: leave verbatim


# --------------------------------------------------------------------------- #
# the two hop preambles
# --------------------------------------------------------------------------- #


def _final_response(messages: list[ModelMessage]) -> ModelResponse | None:
    for message in reversed(messages):
        if isinstance(message, ModelResponse):
            return message
    return None


def structured_output_preamble(new_messages: list[ModelMessage]) -> str:
    """The text the hop said ALONGSIDE its structured final answer.

    Non-empty only when the final response also carries a ``final_result``
    call — i.e. the text is a genuine preamble, not the answer itself
    (reference: _projection.py:116)."""
    from calfkit_tpu_torch.engine.turn import FINAL_RESULT_TOOL

    response = _final_response(new_messages)
    if response is None:
        return ""
    if not any(
        c.tool_name == FINAL_RESULT_TOOL for c in response.tool_calls()
    ):
        return ""  # prompted/native mode: the text IS the answer
    return response.text()


def step_preamble(new_messages: list[ModelMessage]) -> str:
    """The text of the hop's FINAL response — what a non-terminal
    (dispatch/handoff) hop said while acting.  Final-response-only is
    load-bearing: earlier responses in the hop are internal retry chatter
    (reference: _projection.py:139)."""
    response = _final_response(new_messages)
    return response.text() if response is not None else ""
