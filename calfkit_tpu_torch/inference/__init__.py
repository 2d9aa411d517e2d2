"""The model client, serving engine, model math, sampler, attention kernels
and weight conversion of the PyTorch backend.

``initialize_multihost`` and ``assert_engine_fits`` load
:mod:`.distributed` at first use, as the reference's do."""

from typing import Any

from calfkit_tpu_torch.inference.client import TorchLocalModelClient
from calfkit_tpu_torch.inference.config import (
    PRESETS,
    ModelConfig,
    RuntimeConfig,
    SpecConfig,
)

__all__ = [
    "ModelConfig",
    "PRESETS",
    "RuntimeConfig",
    "SpecConfig",
    "TorchLocalModelClient",
    "assert_engine_fits",
    "initialize_multihost",
]


def __getattr__(name: str) -> Any:
    if name in ("initialize_multihost", "assert_engine_fits"):
        from calfkit_tpu_torch.inference import distributed

        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
