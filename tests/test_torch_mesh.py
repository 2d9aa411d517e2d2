"""The mesh contract of ``tests/test_mesh.py`` held against the port.

Every test of the JAX package's mesh suite (the key-ordered dispatcher's
per-key order, its 2n backpressure bound, drain, lane survival; the
in-memory mesh's group delivery and sharing, broadcast taps, oversize
refusal, rebalancing; compacted tables) runs here unchanged against
``calfkit_tpu_torch.mesh``: each test function is rebound to globals in
which ``InMemoryMesh``, ``KeyOrderedDispatcher`` and ``Record`` are the
port's, one parametrised case a test.  The suite's own file keeps running
them against the JAX package.
"""

from __future__ import annotations

import inspect
import types

import pytest

import tests.test_mesh as contract
from calfkit_tpu_torch import mesh as port_mesh

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


def _port_globals() -> dict:
    """The contract module's globals with the mesh names bound to the
    port's, and every module-level helper function rebound to them."""
    g = dict(vars(contract))
    for name in ("InMemoryMesh", "KeyOrderedDispatcher", "Record"):
        assert name in g, name
        g[name] = getattr(port_mesh, name)
    for name, obj in list(g.items()):
        if isinstance(obj, types.FunctionType) and obj.__module__ == contract.__name__:
            g[name] = _rebind(obj, g)
    return g


def _rebind(fn: types.FunctionType, g: dict) -> types.FunctionType:
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


def test_the_contract_is_the_reference_suite():
    assert {s.__name__ for s in SUITES} == {"TestDispatcher", "TestInMemoryMesh", "TestTables"}
    assert len(CASES) == 11
    assert contract.InMemoryMesh.__module__.startswith("calfkit_tpu.")
    assert port_mesh.InMemoryMesh.__module__.startswith("calfkit_tpu_torch.")


@pytest.mark.parametrize("case", CASES, ids=[f"{c}.{n}" for c, n in CASES])
async def test_mesh_contract_on_the_port(case):
    suite_name, name = case
    suite = getattr(contract, suite_name)
    method = vars(suite)[name]
    ported = _rebind(method, _port_globals())
    assert ported.__globals__["InMemoryMesh"] is port_mesh.InMemoryMesh
    result = ported(suite())
    if inspect.isawaitable(result):
        await result
