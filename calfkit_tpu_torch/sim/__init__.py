"""calfkit_tpu_torch.sim — the deterministic fleet harness.

- **seams** (`clock`, `chaos`, `transport`): the virtual clock + event
  heap, scripted fault injectors, the bounded settling primitive, the
  engine no-leak oracle, and the per-replica death/partition transport;
- **fleet shape** (`topology`, `stubs`): N real Workers of one agent
  name on a shared mesh, with engines replaced by serving stubs where a
  scenario does not need a real one;
- **scenario data** (`scenario`): the declarative DSL's pure dataclasses
  (the stubs' ``ServiceSpec`` among them).

The JAX package's scenario runner, pinned suite, report shape and id
minting (``sim/{runner,suite,report,ids}``) are not ported yet.
"""

from calfkit_tpu_torch.sim.chaos import (
    BrokerChaos,
    ChaosScript,
    assert_engine_drained,
    settle,
)
from calfkit_tpu_torch.sim.clock import DEFAULT_EPOCH, VirtualClock, virtual_clock
from calfkit_tpu_torch.sim.scenario import (
    Check,
    LeaseChurn,
    LoadPhase,
    ReplicaEvent,
    Scenario,
    ServiceSpec,
    TenantSpec,
    diurnal_phases,
)
from calfkit_tpu_torch.sim.stubs import (
    BijectiveTokenizer,
    ServingStubModel,
    SimEngineModel,
    StreamingStubModel,
)
from calfkit_tpu_torch.sim.topology import FleetTopology
from calfkit_tpu_torch.sim.transport import ReplicaTransport

__all__ = [
    "BrokerChaos",
    "ChaosScript",
    "assert_engine_drained",
    "settle",
    "DEFAULT_EPOCH",
    "VirtualClock",
    "virtual_clock",
    "Check",
    "LeaseChurn",
    "LoadPhase",
    "ReplicaEvent",
    "Scenario",
    "ServiceSpec",
    "TenantSpec",
    "diurnal_phases",
    "BijectiveTokenizer",
    "ServingStubModel",
    "SimEngineModel",
    "StreamingStubModel",
    "FleetTopology",
    "ReplicaTransport",
]
