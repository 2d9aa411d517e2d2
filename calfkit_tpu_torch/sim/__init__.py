"""calfkit_tpu_torch.sim — the deterministic fleet simulator.

- **seams** (`clock`, `ids`, `chaos`, `transport`): the virtual clock +
  event heap, deterministic id minting, scripted fault injectors, the
  bounded settling primitive, the engine no-leak oracle, and the
  per-replica death/partition transport;
- **fleet shape** (`topology`, `stubs`): N real Workers of one agent
  name on a shared mesh, with engines replaced by serving stubs where a
  scenario does not need a real one;
- **scenarios** (`scenario`, `runner`, `report`): the declarative DSL
  (arrival curves, tenants, scripted death/partition/heal, lease churn),
  the discrete-event runner over the REAL mesh → worker → router path,
  and the SIM.json report shape;
- **the pinned suite** (`suite`): the scenarios SIM.json and
  SIM_BASELINE.json were captured from.
"""

from calfkit_tpu_torch.sim.chaos import (
    BrokerChaos,
    ChaosScript,
    assert_engine_drained,
    settle,
)
from calfkit_tpu_torch.sim.clock import DEFAULT_EPOCH, VirtualClock, virtual_clock
from calfkit_tpu_torch.sim.ids import deterministic_ids
from calfkit_tpu_torch.sim.report import (
    CheckResult,
    ScenarioReport,
    SimReport,
    strip_capture,
)
from calfkit_tpu_torch.sim.runner import SimRunner, run_scenario
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
    "deterministic_ids",
    "CheckResult",
    "ScenarioReport",
    "SimReport",
    "strip_capture",
    "SimRunner",
    "run_scenario",
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
