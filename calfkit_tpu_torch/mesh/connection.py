"""The frozen connection profile threaded to the Kafka wire client.

The port's own copy of ``calfkit_tpu.mesh.connection``: one validated object owns
bootstrap + security + message budget, and every client the transport
creates derives its behavior from it, so the coordinated knobs cannot
drift apart:

- ``max_message_bytes`` is BOTH the producer guard (``publish`` rejects
  bigger values) and the consumer fetch floor
  (``kafka_wire.fetch_floor``), so the biggest legal record can always
  be fetched — a producer-side-only budget would starve consumption of
  the largest legal message.
- ``security`` parses into :class:`calfkit_tpu_torch.mesh.kafka_wire.WireSecurity`
  (TLS + SASL PLAIN/SCRAM); anything unsupported fails loudly at
  construction.
- ``enable_idempotence=True`` is REJECTED by the wire mesh (no
  idempotent-producer sequencing in the native client) — never silently
  honored as at-least-once.
- Raw kwargs that would bypass a coordinated knob are **rejected by name**
  with a pointer at the right knob.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Mapping

DEFAULT_MAX_MESSAGE_BYTES = 5 * 1024 * 1024

# kwarg name -> the knob that owns it
REJECTED_SECURITY_KWARGS: dict[str, str] = {
    "max_request_size": "max_message_bytes",
    "max_partition_fetch_bytes": "max_message_bytes",
    "fetch_max_bytes": "max_message_bytes",
    "enable_idempotence": "enable_idempotence",
    "acks": "the framework (acks=all is load-bearing for the fault rail)",
    "bootstrap_servers": "the positional bootstrap argument",
    "client_id": "client_id",
    "group_id": "subscribe(group_id=...)",
    "auto_offset_reset": "subscribe(from_latest=...)",
    "enable_auto_commit": "the framework (commit cadence is load-bearing)",
}


@dataclass(frozen=True)
class ConnectionProfile:
    """Validated once; one object owns every coordinated connection knob."""

    bootstrap_servers: str
    max_message_bytes: int = DEFAULT_MAX_MESSAGE_BYTES
    enable_idempotence: bool | None = None
    client_id: str = field(
        default_factory=lambda: f"calfkit-{uuid.uuid4().hex[:8]}"
    )
    security: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        # own copy: a caller mutating its dict after construction must not
        # bypass the reject-by-name validation below
        object.__setattr__(self, "security", dict(self.security))
        if self.max_message_bytes <= 0:
            raise ValueError("max_message_bytes must be positive")
        bad = sorted(set(self.security) & set(REJECTED_SECURITY_KWARGS))
        if bad:
            hints = "; ".join(
                f"{name!r} is owned by {REJECTED_SECURITY_KWARGS[name]}"
                for name in bad
            )
            raise ValueError(
                f"security= must not carry coordinated kwargs: {hints}"
            )

