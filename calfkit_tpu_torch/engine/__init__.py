"""The model-client contract of the PyTorch backend: the port's own copy of
the JAX package's seam between an agent turn and a model backend."""

from calfkit_tpu_torch.engine.model_client import (
    ModelClient,
    ModelRequestParameters,
    ModelSettings,
    ResponseDone,
    ResumeOffset,
    StreamEvent,
    TextDelta,
)

__all__ = [
    "ModelClient",
    "ModelRequestParameters",
    "ModelSettings",
    "ResponseDone",
    "ResumeOffset",
    "StreamEvent",
    "TextDelta",
]
