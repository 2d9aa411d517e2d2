"""The serving host (SURVEY.md §1 layer 7)."""

from calfkit_tpu_torch.worker.lifecycle import LifecycleHookMixin
from calfkit_tpu_torch.worker.worker import Worker

__all__ = ["LifecycleHookMixin", "Worker"]
