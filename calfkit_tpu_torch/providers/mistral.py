"""Mistral (la Plateforme) model client (reference: the vendored
pydantic-ai mistral adapter, calfkit/_vendor/pydantic_ai/models/mistral.py
— there a bespoke SDK wrapper; here the same ModelClient seam over the
shared http layer).

Mistral's chat-completions API is OpenAI-shaped with deliberate
deviations, which is why this is a subclass with targeted overrides
rather than a copy:

- ``tool_choice`` uses ``"any"`` where OpenAI spells it ``"required"``;
- only the legacy ``max_tokens`` spelling exists (no reasoning split);
- tool messages carry ``name`` alongside ``tool_call_id``;
- streaming is OpenAI-style SSE with ``[DONE]``, reused verbatim.
"""

from __future__ import annotations

import os
from typing import Any

from calfkit_tpu_torch.engine.model_client import (
    ModelRequestParameters,
    ModelSettings,
)
from calfkit_tpu_torch.models.messages import ModelMessage
from calfkit_tpu_torch.providers.openai import OpenAIModelClient

_DEFAULT_BASE_URL = "https://api.mistral.ai/v1"


class MistralModelClient(OpenAIModelClient):
    """Mistral chat completions over the port's HTTP client; shares the OpenAI render /
    parse / SSE machinery and overrides only the documented deviations."""

    def __init__(
        self,
        model: str,
        *,
        api_key: str | None = None,
        base_url: str = _DEFAULT_BASE_URL,
        http_client: Any | None = None,
    ):
        super().__init__(
            model,
            api_key=api_key or os.environ.get("MISTRAL_API_KEY", ""),
            base_url=base_url,
            http_client=http_client,
            max_tokens_param="max_tokens",  # Mistral has no reasoning split
        )

    def _build_payload(
        self,
        messages: list[ModelMessage],
        settings: ModelSettings,
        params: ModelRequestParameters,
    ) -> dict[str, Any]:
        payload = super()._build_payload(messages, settings, params)
        if payload.get("tool_choice") == "required":
            payload["tool_choice"] = "any"
        # Mistral's tool-result messages carry the tool NAME as well; the
        # OpenAI renderer leaves it off, so thread it back in from the
        # preceding assistant turn's calls
        names: dict[str, str] = {}
        for entry in payload["messages"]:
            for call in entry.get("tool_calls") or []:
                names[call["id"]] = call["function"]["name"]
            if entry.get("role") == "tool" and entry.get("tool_call_id") in names:
                entry["name"] = names[entry["tool_call_id"]]
        return payload
