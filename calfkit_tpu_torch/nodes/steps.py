"""The per-hop step ledger: the SOLE minting authority for wire step events.

Bodies return *facts* (:class:`Said`, :class:`HandedOff`, :class:`DeniedCall`)
wrapped in :class:`Observed`; the ledger turns facts into wire steps and
flushes them exactly once per hop to the run's root callback topic
(reference: calfkit/nodes/_steps.py:100-212; the single-mint rule is
construction-sealed there and enforced by an AST sweep — here it is enforced
by convention: only this module constructs wire ``*Step`` objects inside the
node kernel).

The pair law (reference SURVEY.md §5): every dispatched marked Call mints its
``tool_call`` step at the publish chokepoint and its ``tool_result`` step at
the fold; calls denied before dispatch are born-closed pairs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.keying import partition_key
from calfkit_tpu_torch.models.actions import NodeResult
from calfkit_tpu_torch.models.error_report import ErrorReport, safe_str
from calfkit_tpu_torch.models.step import (
    AgentMessageStep,
    HandoffStep,
    InferenceStep,
    Step,
    StepMessage,
    TokenStep,
    ToolCallStep,
    ToolResultStep,
)

# --------------------------------------------------------------------------- #
# facts: what a body may report having observed
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Said:
    text: str
    author: str | None = None


@dataclass(frozen=True)
class HandedOff:
    to_agent: str
    from_agent: str | None = None


@dataclass(frozen=True)
class DeniedCall:
    """A model tool call rejected before dispatch: a born-closed step pair."""

    tool_call_id: str
    tool_name: str
    reason: str
    args: dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class InferenceFact:
    model_name: str
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    batch_occupancy: float = 0.0
    tokens_per_second: float = 0.0


Fact = Said | HandedOff | DeniedCall | InferenceFact


@dataclass
class Observed:
    """A body's widened return: the action plus telemetry facts."""

    action: NodeResult
    facts: list[Fact] = field(default_factory=list)


# --------------------------------------------------------------------------- #
# the ledger
# --------------------------------------------------------------------------- #


class HopStepLedger:
    """Created per delivery; flushed once at hop exit, best-effort."""

    def __init__(self, emitter: str):
        self._emitter = emitter
        self._steps: list[Step] = []
        self._flushed = False

    # ------------------------------------------------------------- absorb
    def absorb(self, facts: list[Fact]) -> None:
        for fact in facts:
            if isinstance(fact, Said):
                self._steps.append(AgentMessageStep(text=fact.text, author=fact.author))
            elif isinstance(fact, HandedOff):
                self._steps.append(
                    HandoffStep(to_agent=fact.to_agent, from_agent=fact.from_agent)
                )
            elif isinstance(fact, DeniedCall):
                self._steps.append(
                    ToolCallStep(
                        tool_call_id=fact.tool_call_id,
                        tool_name=fact.tool_name,
                        args=fact.args,
                        denied=True,
                    )
                )
                self._steps.append(
                    ToolResultStep(
                        tool_call_id=fact.tool_call_id,
                        tool_name=fact.tool_name,
                        ok=False,
                        content=fact.reason,
                    )
                )
            elif isinstance(fact, InferenceFact):
                self._steps.append(
                    InferenceStep(
                        model_name=fact.model_name,
                        prefill_ms=fact.prefill_ms,
                        decode_ms=fact.decode_ms,
                        prompt_tokens=fact.prompt_tokens,
                        generated_tokens=fact.generated_tokens,
                        batch_occupancy=fact.batch_occupancy,
                        tokens_per_second=fact.tokens_per_second,
                    )
                )

    def note_dispatch(
        self, tool_call_id: str, tool_name: str, args: dict[str, Any]
    ) -> None:
        """Minted at the publish chokepoint for every marked outgoing Call."""
        self._steps.append(
            ToolCallStep(tool_call_id=tool_call_id, tool_name=tool_name, args=args)
        )

    def folded(
        self, tool_call_id: str, tool_name: str, content: Any, *,
        ok: bool = True,
    ) -> None:
        """``ok=False`` with content: the callee faulted but a recovery seam
        substituted a value — honest telemetry shows the failure AND what
        the model will see instead."""
        self._steps.append(
            ToolResultStep(
                tool_call_id=tool_call_id,
                tool_name=tool_name,
                ok=ok,
                content=safe_str(content, 2048),
            )
        )

    def fold_failed(
        self, tool_call_id: str, tool_name: str, report: ErrorReport
    ) -> None:
        self._steps.append(
            ToolResultStep(
                tool_call_id=tool_call_id,
                tool_name=tool_name,
                ok=False,
                content=report.describe(),
            )
        )

    def token(self, text: str, author: str | None = None) -> None:
        self._steps.append(TokenStep(text=text, author=author))

    # -------------------------------------------------------------- flush
    @property
    def has_steps(self) -> bool:
        return bool(self._steps)

    def drain(self) -> StepMessage | None:
        """Take the batch (idempotent: second call returns None)."""
        if self._flushed or not self._steps:
            return None
        self._flushed = True
        return StepMessage(steps=self._steps, emitter=self._emitter)

    async def flush(
        self,
        transport: Any,
        root_topic: str | None,
        *,
        correlation_id: str | None,
        task_id: str | None,
    ) -> None:
        """Publish the hop's steps to the run's root callback topic.

        Best-effort: failure is floor-logged by the caller, never faults the
        run (reference: base.py:530-570).
        """
        message = self.drain()
        if message is None or root_topic is None:
            return
        await publish_step_message(
            transport,
            root_topic,
            message,
            correlation_id=correlation_id,
            task_id=task_id,
        )


async def publish_step_message(
    transport: Any,
    root_topic: str,
    message: StepMessage,
    *,
    correlation_id: str | None,
    task_id: str | None,
) -> None:
    """The ONE way a wire StepMessage reaches the step stream — used by the
    hop ledger's flush and by live token streaming, so headers/keying can
    never diverge."""
    headers = {protocol.HDR_WIRE: "step", protocol.HDR_EMITTER: message.emitter}
    if correlation_id:
        headers[protocol.HDR_CORRELATION] = correlation_id
    if task_id:
        headers[protocol.HDR_TASK] = task_id
    await transport.publish(
        root_topic,
        message.to_wire(),
        key=partition_key(task_id) if task_id else None,
        headers=headers,
    )
