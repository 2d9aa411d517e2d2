"""The mesh contract of ``tests/test_mesh.py`` held against the port.

Every test of the JAX package's mesh suite (the key-ordered dispatcher's
per-key order, its 2n backpressure bound, drain, lane survival; the
in-memory mesh's group delivery and sharing, broadcast taps, oversize
refusal, rebalancing; compacted tables) runs here unchanged against
``calfkit_tpu_torch.mesh``: the suite module is rebound by
``tests/_torch_rebind.py``, so ``InMemoryMesh``, ``KeyOrderedDispatcher``
and ``Record`` are the port's, one parametrised case a test.  The suite's
own file keeps running them against the JAX package.
"""

from __future__ import annotations

import inspect

import pytest

import tests.test_mesh as contract
from calfkit_tpu_torch import mesh as port_mesh
from tests._torch_rebind import ported_module

SUITES = [
    obj for name, obj in vars(contract).items()
    if name.startswith("Test") and inspect.isclass(obj)
]
CASES = [
    (suite.__name__, name)
    for suite in SUITES
    for name in sorted(vars(suite))
    if name.startswith("test_")
]


def test_the_contract_is_the_reference_suite():
    assert {s.__name__ for s in SUITES} == {"TestDispatcher", "TestInMemoryMesh", "TestTables"}
    assert len(CASES) == 11
    assert contract.InMemoryMesh.__module__.startswith("calfkit_tpu.")
    assert port_mesh.InMemoryMesh.__module__.startswith("calfkit_tpu_torch.")
    g = ported_module(contract.__name__)
    for name in ("InMemoryMesh", "KeyOrderedDispatcher", "Record"):
        assert g[name] is getattr(port_mesh, name), name


@pytest.mark.parametrize("case", CASES, ids=[f"{c}.{n}" for c, n in CASES])
async def test_mesh_contract_on_the_port(case):
    suite_name, name = case
    suite = ported_module(contract.__name__)[suite_name]
    ported = vars(suite)[name]
    assert ported.__globals__["InMemoryMesh"] is port_mesh.InMemoryMesh
    result = ported(suite())
    if inspect.isawaitable(result):
        await result
