"""Control plane: discovery + liveness over compacted mesh tables
(SURVEY.md §1 layer 5)."""

from calfkit_tpu_torch.controlplane.config import ControlPlaneConfig
from calfkit_tpu_torch.controlplane.publisher import ControlPlanePublisher
from calfkit_tpu_torch.controlplane.view import ControlPlaneView
from calfkit_tpu_torch.controlplane.plane import ControlPlane
from calfkit_tpu_torch.models.records import ControlPlaneRecord, ControlPlaneStamp

__all__ = [
    "ControlPlane",
    "ControlPlaneConfig",
    "ControlPlaneRecord",
    "ControlPlaneStamp",
    "ControlPlanePublisher",
    "ControlPlaneView",
]
