"""Remote-API model clients: the JAX package's ``calfkit_tpu.providers``
on the port.

Reference: calfkit/providers/pydantic_ai/*.py (thin sugar over the vendored
``Model`` ABC; SURVEY.md §1 layer 4).  Here the card-local
``TorchLocalModelClient`` is the DEFAULT path; these HTTP clients exist so a
reference user migrating an OpenAI/Anthropic deployment finds the same
providers, speaking the same :class:`calfkit_tpu_torch.engine.ModelClient`
seam, and ``FallbackModelClient(TorchLocalModelClient(...),
OpenAIModelClient(...))`` keeps a remote API as the local engine's parachute.

All go through the port's own HTTP client (:mod:`calfkit_tpu_torch._http`;
no vendor SDKs, no httpx), honor ``ModelSettings``, map tool calls both
ways, and raise :class:`ModelAPIError` with the HTTP status and body on
failure — which the agent turn runner converts into a typed
``mesh.model_error`` fault.  ``http_client=HTTPClient(transport=
MockTransport(handler))`` answers a client in-process, as tests do.
"""

from calfkit_tpu_torch.providers.anthropic import AnthropicModelClient
from calfkit_tpu_torch.providers.bedrock import BedrockModelClient
from calfkit_tpu_torch.providers.fallback import (
    FallbackExhaustedError,
    FallbackModelClient,
)
from calfkit_tpu_torch.providers.gemini import GeminiModelClient
from calfkit_tpu_torch.providers.http import ModelAPIError
from calfkit_tpu_torch.providers.mistral import MistralModelClient
from calfkit_tpu_torch.providers.openai import OpenAIModelClient
from calfkit_tpu_torch.providers.openai_responses import OpenAIResponsesModelClient

__all__ = [
    "AnthropicModelClient",
    "BedrockModelClient",
    "FallbackExhaustedError",
    "FallbackModelClient",
    "GeminiModelClient",
    "MistralModelClient",
    "ModelAPIError",
    "OpenAIModelClient",
    "OpenAIResponsesModelClient",
]
