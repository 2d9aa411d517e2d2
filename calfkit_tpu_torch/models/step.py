"""Step (telemetry) wire models — per-hop *semantic* events, not spans.

Two frozen families (reference: calfkit/models/step.py:96-186):

- wire ``*Step`` — identity-free facts minted by the node's step ledger and
  shipped in a :class:`StepMessage` to the run's root callback topic;
- surface :class:`StepEvent` — the caller-side projection with identity
  (correlation/task/node) stamped on, fed to ``handle.stream()`` and the
  client firehose.

Only the hop ledger may mint wire steps (single-authority rule); nodes return
facts, the ledger turns them into steps.  ``InferenceStep`` is new to the TPU
build: per-turn prefill/decode metrics from the local backend (SURVEY.md §5
tracing note).
"""

from __future__ import annotations

from typing import Any, Literal, Union

from dataclasses import dataclass, field

from calfkit_tpu_torch.models._wire import Wire


@dataclass(frozen=True, kw_only=True)
class AgentMessageStep(Wire):
    kind: Literal["agent_message"] = "agent_message"
    author: str | None = None
    text: str = ""


@dataclass(frozen=True, kw_only=True)
class ThinkingStep(Wire):
    """Defined but not emitted by default (parity with the reference)."""

    kind: Literal["thinking"] = "thinking"
    author: str | None = None
    text: str = ""


@dataclass(frozen=True, kw_only=True)
class ToolCallStep(Wire):
    kind: Literal["tool_call"] = "tool_call"
    tool_call_id: str
    tool_name: str
    args: dict[str, Any] = field(default_factory=dict)
    denied: bool = False  # born-closed pair for calls denied before dispatch


@dataclass(frozen=True, kw_only=True)
class ToolResultStep(Wire):
    kind: Literal["tool_result"] = "tool_result"
    tool_call_id: str
    tool_name: str
    ok: bool = True
    content: str = ""


@dataclass(frozen=True, kw_only=True)
class HandoffStep(Wire):
    kind: Literal["handoff"] = "handoff"
    from_agent: str | None = None
    to_agent: str = ""


@dataclass(frozen=True, kw_only=True)
class TokenStep(Wire):
    """Incremental generated text from a streaming model turn.

    ``offset`` is the absolute character offset of this chunk
    within the run's delivered answer text, stamped ONLY by a turn that
    RESUMED decode-from-offset (its first chunk starts at the
    delivered-prefix length) — the caller-side
    ``StreamLedger`` (the JAX package's fleet failover) then dedupes
    exactly, suppressing nothing.  ``None`` (non-resumed turns,
    older emitters, internal output retries) rides the ledger's
    cumulative law, which carries across an agent's tool-calling turns."""

    kind: Literal["token"] = "token"
    author: str | None = None
    text: str = ""
    offset: int | None = None


@dataclass(frozen=True, kw_only=True)
class InferenceStep(Wire):
    """Local-backend metrics for one model turn (TPU-build extension)."""

    kind: Literal["inference"] = "inference"
    model_name: str = ""
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    batch_occupancy: float = 0.0
    tokens_per_second: float = 0.0


Step = Union[
        AgentMessageStep,
        ThinkingStep,
        ToolCallStep,
        ToolResultStep,
        HandoffStep,
        TokenStep,
        InferenceStep,
    ]


@dataclass(frozen=True, kw_only=True)
class StepMessage(Wire):
    """Wire batch: every step minted during one hop, flushed once at hop exit."""
    steps: list[Step] = field(default_factory=list)
    emitter: str = ""  # "<kind>/<name>" of the minting node

    def to_wire(self) -> bytes:
        return self.model_dump_json(exclude_none=True).encode("utf-8")

    @classmethod
    def from_wire(cls, data: bytes | str) -> "StepMessage":
        return cls.model_validate_json(data)


@dataclass(kw_only=True)
class StepEvent(Wire):
    """Surface event: a wire step with run identity stamped caller-side."""

    correlation_id: str
    task_id: str | None = None
    node: str | None = None
    step: Step
