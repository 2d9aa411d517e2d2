"""The fleet simulator of the JAX package's suite, held against the port, and
the two packages' runners side by side.

**The reference suite, rebound.**  The cases of ``tests/test_sim.py`` (the
virtual event clock, deterministic id minting, the scenario DSL, the runner
over the real mesh → worker → router path with kills, heals and lease
churn, the failover uncharge, determinism, the perf gate's baseline and
bands over the port's reports, the chaos shim and ``ck sim``) run here
unchanged against ``calfkit_tpu_torch``, one parametrised case a test, the
suite rebound by ``tests/_torch_rebind.py``: its ``calfkit_tpu`` names are
the port's, its module-scope ``SMOKE`` scenario is rebuilt from the port's
dataclasses, and its report cache starts empty.  ``scripts/perf_gate.py``,
which the gate's cases load, takes the port's reports as they are.  Left
out: ``TestBenchStaleStamp`` (2 cases), which drives the JAX package's
``bench.py``.  The pinned suite's full-size determinism case keeps the
suite's own ``slow`` mark.

**Two packages, one report.**  ``SimRunner`` on every ``PINNED_SUITE``
scenario, scaled as the suite's tests scale it, gives the same report in
both packages at the same seed, metric for metric and verdict for verdict,
byte for byte as JSON.  (The full-size suite against the committed
``SIM.json`` and ``SIM_BASELINE.json`` is ``scripts/torch_sim_suite.py``,
minutes of host time.)
"""

from __future__ import annotations

import asyncio
import importlib
import inspect
import json

import pytest

from tests._torch_rebind import Absent, port_data, ported_module

# contract module -> {suite class: cases rebound}
SUITES = {
    "tests.test_sim": {
        "TestVirtualEventClock": 4, "TestDeterministicIds": 1, "TestScenarioDsl": 5,
        "TestSimRunner": 5, "TestFailoverUncharge": 1, "TestDeterminism": 3, "TestPerfGate": 6,
        "TestChaosShim": 1, "TestCkSim": 2},
}
# the cases the port cannot run, and why
LEFT_OUT = {"TestBenchStaleStamp": "drives the JAX package's bench.py"}


def _case(module_name: str, suite_name: str, name: str):
    method = vars(getattr(importlib.import_module(module_name), suite_name))[name]
    # the suite's own marks (its full-size determinism case is slow)
    marks = [m for m in getattr(method, "pytestmark", []) if m.name == "slow"]
    return pytest.param(module_name, suite_name, name, marks=marks,
                        id=f"{suite_name}.{name}")


CASES = [
    _case(module_name, suite_name, name)
    for module_name, suites in SUITES.items()
    for suite_name in suites
    for name in vars(getattr(importlib.import_module(module_name), suite_name))
    if name.startswith("test_")
]


def _suite() -> dict:
    """``tests/test_sim.py`` rebound: its scenario of module scope rebuilt
    from the port's dataclasses, its report cache its own."""
    reference = importlib.import_module("tests.test_sim")
    return ported_module("tests.test_sim", overrides={
        "SMOKE": port_data(reference.SMOKE), "_SMOKE_CACHE": {},
    })


def test_the_contract_is_the_reference_suite():
    counts: dict = {}
    for case in CASES:
        module_name, suite_name, _ = case.values
        counts.setdefault(module_name, {}).setdefault(suite_name, 0)
        counts[module_name][suite_name] += 1
    assert counts == SUITES
    assert len(CASES) == 28
    reference = importlib.import_module("tests.test_sim")
    suites = {name for name, obj in vars(reference).items()
              if isinstance(obj, type) and name.startswith("Test")}
    assert suites == set(SUITES["tests.test_sim"]) | set(LEFT_OUT)
    # the rebound globals are the port's
    g = _suite()
    from calfkit_tpu_torch import sim
    from calfkit_tpu_torch.sim import suite

    for name in ("SimRunner", "SimReport", "Scenario", "deterministic_ids", "strip_capture"):
        assert g[name] is getattr(sim, name), name
    assert g["PINNED_SUITE"] is suite.PINNED_SUITE
    assert type(g["SMOKE"]) is sim.Scenario and type(g["SMOKE"].service) is sim.ServiceSpec
    assert {type(c) for c in g["SMOKE"].checks} == {sim.Check}
    assert g["_SMOKE_CACHE"] is not reference._SMOKE_CACHE
    assert not any(isinstance(value, Absent) for value in g.values())


@pytest.mark.parametrize("module_name,suite_name,name", CASES)
def test_sim_contract_on_the_port(module_name, suite_name, name):
    g = _suite()
    suite = g[suite_name]
    method = vars(suite)[name]
    assert method.__globals__ is g
    assert not [p for p in inspect.signature(method).parameters if p != "self"]
    result = method(suite())
    if inspect.isawaitable(result):
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(asyncio.wait_for(result, timeout=300))
        finally:
            loop.close()


# --------------------------------------------------------------------------- #
# two packages, one report
# --------------------------------------------------------------------------- #

SCALE = 0.1  # as the suite's own tests scale the pinned suite


def _scenario_names() -> "list[str]":
    from calfkit_tpu_torch.sim.suite import PINNED_SUITE

    return [scenario.name for scenario in PINNED_SUITE]


@pytest.mark.parametrize("name", _scenario_names())
def test_runner_report_equals_the_reference(name):
    """One scenario of the pinned suite through both packages' runners at
    the same seed: the same report, as the JSON document SIM.json holds,
    byte for byte (every metric, every check's value and verdict)."""
    from calfkit_tpu.sim import SimRunner as RefRunner
    from calfkit_tpu.sim.suite import scaled_suite as ref_scaled
    from calfkit_tpu_torch.sim import SimRunner
    from calfkit_tpu_torch.sim.suite import scaled_suite

    ref = next(s for s in ref_scaled(SCALE) if s.name == name)
    port = next(s for s in scaled_suite(SCALE) if s.name == name)
    assert port == port_data(ref)  # the same scenario, value for value
    want = asyncio.run(RefRunner(ref).run()).to_dict()
    got = asyncio.run(SimRunner(port).run()).to_dict()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["metrics"]["requests"]["offered"] > 0
