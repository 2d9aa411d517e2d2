"""Control-plane tuning: the port's own copy of
``calfkit_tpu.controlplane.config``."""

from __future__ import annotations

from dataclasses import dataclass

from calfkit_tpu_torch.models._wire import invalid
from calfkit_tpu_torch.tuning import require_positive


@dataclass(frozen=True, kw_only=True)
class ControlPlaneConfig:
    enabled: bool = True
    heartbeat_interval: float = 5.0
    # a node is live while now - heartbeat_at < stale_multiplier × interval
    stale_multiplier: float = 3.0
    catchup_timeout: float = 30.0

    def __post_init__(self) -> None:
        require_positive("ControlPlaneConfig", "heartbeat_interval", self.heartbeat_interval)
        if not self.stale_multiplier >= 1.0:
            raise invalid(
                "ControlPlaneConfig", "stale_multiplier",
                "Input should be greater than or equal to 1", self.stale_multiplier,
            )
        require_positive("ControlPlaneConfig", "catchup_timeout", self.catchup_timeout)

    @property
    def stale_after(self) -> float:
        return self.heartbeat_interval * self.stale_multiplier
