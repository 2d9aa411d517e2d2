"""The model client, serving engine, model math, sampler, attention kernels
and weight conversion of the PyTorch backend."""

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
]
