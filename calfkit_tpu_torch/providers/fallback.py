"""Provider composition: try models in order, falling back on failure.

Reference: calfkit/_vendor/pydantic_ai/models/fallback.py:23-158
(``FallbackModel``).  Same semantics on our ModelClient seam: each model is
tried in sequence; exceptions matching ``fallback_on`` accumulate and the
next model runs; a non-matching exception propagates immediately; when
every model fails, a :class:`FallbackExhaustedError` carries all of them.

The load-bearing composition here is **the local card first, remote API as the
parachute**: ``FallbackModelClient(TorchLocalModelClient(...),
OpenAIModelClient(...))`` keeps the default quickstart fully local and
only pays network latency when the local engine refuses a request.

Streaming: our seam is an async generator, so fallback applies only while
nothing has been yielded — once the consumer saw an event, a mid-stream
failure propagates (tokens cannot be un-streamed; the reference's
context-manager seam has the same cutoff at stream open).
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Callable, Sequence

from calfkit_tpu_torch.engine.model_client import (
    ModelClient,
    ModelRequestParameters,
    ModelSettings,
    StreamEvent,
)
from calfkit_tpu_torch.exceptions import CalfkitError
from calfkit_tpu_torch.models.messages import ModelMessage, ModelResponse
from calfkit_tpu_torch.providers.http import ModelAPIError


class FallbackExhaustedError(CalfkitError):
    """Every model in a FallbackModelClient failed.

    ``exceptions`` holds each model's failure in try order; the message
    names the models so a mesh fault stays diagnosable after safe_str.
    """

    def __init__(self, models: Sequence[str], exceptions: list[Exception]):
        self.exceptions = list(exceptions)
        details = "; ".join(
            f"{name}: {type(exc).__name__}: {exc}"[:200]
            for name, exc in zip(models, exceptions)
        )
        super().__init__(
            f"all {len(exceptions)} fallback models failed ({details})"
        )


def _condition(
    fallback_on: "Callable[[Exception], bool] | tuple[type[Exception], ...]",
) -> Callable[[Exception], bool]:
    if isinstance(fallback_on, tuple):
        types = fallback_on

        def matches(exc: Exception) -> bool:
            return isinstance(exc, types)

        return matches
    return fallback_on


class FallbackModelClient(ModelClient):
    """Try each model in order; fall back on matching failures.

    ``fallback_on`` is a tuple of exception types (default: the typed
    remote-API failure plus transport-level errors, so a dead local engine
    or an unreachable endpoint both roll over) or a callable predicate.
    """

    def __init__(
        self,
        *models: ModelClient,
        fallback_on: (
            "Callable[[Exception], bool] | tuple[type[Exception], ...]"
        ) = (ModelAPIError, ConnectionError, TimeoutError, OSError),
    ):
        if not models:
            raise ValueError("FallbackModelClient needs at least one model")
        self.models = list(models)
        self._fallback_on = _condition(fallback_on)

    @property
    def model_name(self) -> str:
        return "fallback:" + ",".join(m.model_name for m in self.models)

    async def request(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> ModelResponse:
        exceptions: list[Exception] = []
        for model in self.models:
            try:
                return await model.request(messages, settings, params)
            except Exception as exc:  # noqa: BLE001 - classified below
                if not self._fallback_on(exc):
                    raise
                exceptions.append(exc)
        raise FallbackExhaustedError(
            [m.model_name for m in self.models], exceptions
        )

    async def request_stream(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings | None = None,
        params: ModelRequestParameters | None = None,
    ) -> AsyncIterator[StreamEvent]:
        from calfkit_tpu_torch.engine.model_client import ResumeOffset

        exceptions: list[Exception] = []
        for model in self.models:
            yielded = False
            # a ResumeOffset is HELD until the same backend produces a
            # text-bearing event: it carries no text (a backend that
            # announced a resume then failed delivered nothing, so
            # fallback stays legal), and forwarding it eagerly would
            # poison the consumer's offset space if the NEXT backend
            # regenerates from zero — the held offset is simply dropped
            # with the failed backend
            pending_offset: "ResumeOffset | None" = None
            try:
                async for event in model.request_stream(
                    messages, settings, params
                ):
                    if isinstance(event, ResumeOffset):
                        pending_offset = event
                        continue
                    if pending_offset is not None:
                        yielded = True
                        yield pending_offset
                        pending_offset = None
                    yielded = True
                    yield event
                return
            except Exception as exc:  # noqa: BLE001 - classified below
                if yielded or not self._fallback_on(exc):
                    # tokens already reached the consumer: a silent retry
                    # would duplicate them — surface the truth instead
                    raise
                exceptions.append(exc)
        raise FallbackExhaustedError(
            [m.model_name for m in self.models], exceptions
        )

    async def aclose(self) -> None:
        for model in self.models:
            close = getattr(model, "aclose", None)
            if close is not None:
                await close()

    async def start(self) -> None:
        """Start any child that wants starting (TorchLocalModelClient does)."""
        for model in self.models:
            start: Any = getattr(model, "start", None)
            if start is not None:
                await start()
