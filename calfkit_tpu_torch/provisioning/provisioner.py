"""Topic-set derivation + idempotent creation with error classification.

The port's own copy of ``calfkit_tpu.provisioning.provisioner``
(``topics_for_nodes`` / ``framework_topics_for_nodes`` and the
created/existing/unauthorized/retry classification).  The transport's
``ensure_topics`` performs the actual creation; this module owns which
topics exist, why, and how their creation failures are treated:

- **existing** — another worker won the race; success.
- **retry** — transient broker trouble (timeouts, leader elections,
  connection loss); bounded backoff, then give up loudly.
- **unauthorized** — an ACL problem no retry will fix; fail immediately
  with a message that says so (the most important distinction:
  an unauthorized cluster must not look like a flaky one).
- **fatal** — everything else; fail immediately.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Iterable

from dataclasses import dataclass

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.exceptions import ProvisioningError
from calfkit_tpu_torch.mesh.transport import MeshTransport
from calfkit_tpu_torch.models._wire import Wire, invalid
from calfkit_tpu_torch.nodes.base import BaseNodeDef

logger = logging.getLogger(__name__)


@dataclass(frozen=True, kw_only=True)
class ProvisioningConfig(Wire):
    __wire_extra__ = "forbid"

    enabled: bool = True
    include_framework: bool = True
    max_attempts: int = 3
    retry_backoff_s: float = 0.5

    def __post_init__(self) -> None:
        super().__post_init__()
        if not self.max_attempts >= 1:
            raise invalid(
                "ProvisioningConfig", "max_attempts",
                "Input should be greater than or equal to 1", self.max_attempts,
            )
        if not self.retry_backoff_s >= 0.0:
            raise invalid(
                "ProvisioningConfig", "retry_backoff_s",
                "Input should be greater than or equal to 0", self.retry_backoff_s,
            )


_EXISTING_MARKERS = ("alreadyexists", "already exists")
_UNAUTHORIZED_MARKERS = (
    "authorization", "authentication", "unauthorized", "accessdenied",
    "saslauthentication", "aclauthorization",
)
_RETRIABLE_MARKERS = (
    "timeout", "timedout", "connection", "notcontroller", "retriable",
    "unavailable", "leadernotavailable", "notcoordinator", "networkerror",
    "nodenotready", "brokerresponseerror",
)


def classify_topic_error(exc: BaseException) -> str:
    """→ "existing" | "unauthorized" | "retry" | "fatal".

    Matching is by exception type name and message (transport-agnostic: the
    kafka client's error class names carry the semantics; other transports
    raise stdlib TimeoutError/ConnectionError which land in "retry").
    """
    haystack = f"{type(exc).__name__} {exc}".lower()
    if isinstance(exc, (PermissionError,)):
        return "unauthorized"
    for marker in _UNAUTHORIZED_MARKERS:
        if marker in haystack:
            return "unauthorized"
    for marker in _EXISTING_MARKERS:
        if marker in haystack:
            return "existing"
    if isinstance(exc, (TimeoutError, ConnectionError, OSError)):
        return "retry"
    for marker in _RETRIABLE_MARKERS:
        if marker in haystack:
            return "retry"
    return "fatal"


def topics_for_nodes(nodes: Iterable[BaseNodeDef]) -> list[str]:
    """Every topic the nodes themselves consume or publish."""
    topics: set[str] = set()
    for node in nodes:
        topics.update(node.all_topics())
    return sorted(topics)


def framework_topics_for_nodes(nodes: Iterable[BaseNodeDef]) -> list[str]:
    """Framework-owned topics backing the nodes: control plane + durable
    fan-out tables (compacted)."""
    topics: set[str] = {
        protocol.AGENTS_TOPIC,
        protocol.CAPABILITIES_TOPIC,
        protocol.ENGINE_STATS_TOPIC,
        protocol.TRACES_TOPIC,
        protocol.CALLER_LIVENESS_TOPIC,
    }
    for node in nodes:
        topics.add(protocol.fanout_state_topic(node.node_id))
        topics.add(protocol.fanout_basestate_topic(node.node_id))
    return sorted(topics)


async def provision(
    transport: MeshTransport,
    nodes: Iterable[BaseNodeDef],
    config: ProvisioningConfig | None = None,
) -> dict[str, list[str]]:
    """Create all topics for ``nodes``; returns {"plain": [...], "compacted":
    [...]} of what was ensured.  Raises ProvisioningError on failure."""
    config = config or ProvisioningConfig()
    if not config.enabled:
        return {"plain": [], "compacted": []}
    nodes = list(nodes)
    plain = topics_for_nodes(nodes)
    compacted = framework_topics_for_nodes(nodes) if config.include_framework else []

    class _ExistsInBatch(Exception):
        """Batch create hit an already-exists: fall back to per-topic."""

    async def attempt(names: list[str], *, compact: bool) -> None:
        for attempt in range(1, config.max_attempts + 1):
            try:
                await transport.ensure_topics(names, compacted=compact)
                return
            except Exception as exc:  # noqa: BLE001 - classified below
                kind = classify_topic_error(exc)
                if kind == "existing":
                    if len(names) > 1:
                        # one existing topic must not mask missing siblings
                        raise _ExistsInBatch from exc
                    return  # a racing worker created it: success
                if kind == "retry" and attempt < config.max_attempts:
                    delay = config.retry_backoff_s * (2 ** (attempt - 1))
                    logger.warning(
                        "topic provisioning attempt %d/%d failed (%s); "
                        "retrying in %.1fs: %s",
                        attempt, config.max_attempts, kind, delay, exc,
                    )
                    await asyncio.sleep(delay)
                    continue
                if kind == "unauthorized":
                    raise ProvisioningError(
                        "topic provisioning UNAUTHORIZED (no retry will "
                        f"fix this — grant create-topics ACLs or pre-create "
                        f"{names}): {exc}"
                    ) from exc
                raise ProvisioningError(
                    f"topic provisioning failed ({kind}, "
                    f"attempt {attempt}/{config.max_attempts}): {exc}"
                ) from exc

    async def ensure(names: list[str], *, compact: bool) -> None:
        if not names:
            return
        # layering note: in-repo transports implement ensure_topics
        # idempotently (KafkaWireMesh does its own batch→per-topic exists
        # handling), so this fallback is the cross-transport safety net for
        # implementations that DO surface already-exists errors
        try:
            await attempt(names, compact=compact)  # one round trip, usually
        except _ExistsInBatch:
            for name in names:  # fallback: per-topic, each one classified
                await attempt([name], compact=compact)

    await ensure(plain, compact=False)
    if compacted:
        await ensure(compacted, compact=True)
    logger.info(
        "provisioned %d topics (%d compacted)", len(plain) + len(compacted),
        len(compacted),
    )
    return {"plain": plain, "compacted": compacted}
