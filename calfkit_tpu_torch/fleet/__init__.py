"""Serving fleet: replicated engines behind load-, drain- and
prefix-aware mesh routing (see docs/fleet.md).

Layers:

- :mod:`calfkit_tpu_torch.fleet.selection` — pure hashing/ranking
  primitives shared with the mesh dispatcher's lane law;
- :mod:`calfkit_tpu_torch.fleet.registry` — the per-instance replica view
  over the compacted ``mesh.engine_stats`` heartbeats;
- :mod:`calfkit_tpu_torch.fleet.policy` — the routing-policy seam
  (least-loaded, power-of-two-choices, prefix-affinity, random);
- :mod:`calfkit_tpu_torch.fleet.router` — registry + policy → one topic
  per call, shared-topic fail-open;
- :mod:`calfkit_tpu_torch.fleet.failover` — in-flight failure recovery:
  the dead-placement law, the caller's failover/hedge policy, and the
  stream-resume dedupe ledger.

Re-exports are LAZY (mirroring ``calfkit_tpu_torch/__init__``): the mesh
dispatcher imports ``fleet.selection`` for its lane law, and that import
must stay stdlib-only — an eager ``__init__`` would drag the wire codec
and the control-plane models into every process that merely dispatches
records.
"""

from __future__ import annotations

from importlib import import_module
from typing import TYPE_CHECKING, Any

_LAZY: dict[str, str] = {
    "FailoverPolicy": "calfkit_tpu_torch.fleet.failover",
    "StreamLedger": "calfkit_tpu_torch.fleet.failover",
    "placement_verdict": "calfkit_tpu_torch.fleet.failover",
    "FleetRouter": "calfkit_tpu_torch.fleet.router",
    "Route": "calfkit_tpu_torch.fleet.router",
    "LeastLoaded": "calfkit_tpu_torch.fleet.policy",
    "PowerOfTwoChoices": "calfkit_tpu_torch.fleet.policy",
    "PrefixAffinity": "calfkit_tpu_torch.fleet.policy",
    "RandomChoice": "calfkit_tpu_torch.fleet.policy",
    "RouteRequest": "calfkit_tpu_torch.fleet.policy",
    "RoutingPolicy": "calfkit_tpu_torch.fleet.policy",
    "affinity_key_for": "calfkit_tpu_torch.fleet.policy",
    "resolve_policy": "calfkit_tpu_torch.fleet.policy",
    "Replica": "calfkit_tpu_torch.fleet.registry",
    "ReplicaRegistry": "calfkit_tpu_torch.fleet.registry",
    "eligibility_verdict": "calfkit_tpu_torch.fleet.registry",
    "parse_replicas": "calfkit_tpu_torch.fleet.registry",
}

__all__ = sorted(_LAZY)

if TYPE_CHECKING:  # pragma: no cover
    from calfkit_tpu_torch.fleet.failover import (
        FailoverPolicy,
        StreamLedger,
        placement_verdict,
    )
    from calfkit_tpu_torch.fleet.policy import (
        LeastLoaded,
        PowerOfTwoChoices,
        PrefixAffinity,
        RandomChoice,
        RouteRequest,
        RoutingPolicy,
        affinity_key_for,
        resolve_policy,
    )
    from calfkit_tpu_torch.fleet.registry import (
        Replica,
        ReplicaRegistry,
        eligibility_verdict,
        parse_replicas,
    )
    from calfkit_tpu_torch.fleet.router import FleetRouter, Route


def __getattr__(name: str) -> Any:
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)


def __dir__() -> "list[str]":
    return sorted(set(globals()) | set(_LAZY))
