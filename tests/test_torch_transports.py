"""The wire transports and the provisioner of the JAX package's suites, held
against the port, and the two packages on one broker.

**The reference suites, rebound.**  Every test of ``tests/test_tcp_mesh.py``,
``test_meshd_barrage.py``, ``test_kafka_wire.py``, ``test_wire_routing.py``,
``test_wire_robustness.py``, ``test_wire_recovery.py``,
``test_kafka_security.py``, ``test_kafka_codec_fuzz.py``,
``test_broker_restart.py``, ``test_provisioning.py`` and
``test_connection_hardening.py`` runs here unchanged against
``calfkit_tpu_torch``, one parametrised case a test (a parametrised test
gives one case a parameter set), each suite module rebound onto the port
by ``tests/_torch_rebind.py`` (its ``calfkit_tpu`` names, the imports in
its test bodies and the module names in its strings become the port's).
The suites' own files keep running them against the JAX package.

The fixtures are this file's: every broker they spawn binds port 0 (never
the fixed ports of the JAX package's files, which run beside this one), and
a missing broker binary fails the case instead of skipping it.  The broker
restart cases choose their port as their suite does (the OS's free port),
since a restarted broker must come back on the same address.

**Interop.**  Against one ``kafkad``, and again against one ``meshd``, a
``Client`` of one package runs the quickstart's agent turn (a scripted test
model, one tool hop) that a ``Worker`` of the other package serves, both
ways.  With ``uuid.uuid4`` replaced by one seeded counter, the result and
every record published, by (topic, key), equal an all-reference run on a
broker of the same kind.
"""

from __future__ import annotations

import asyncio
import importlib
import inspect

import pytest

from calfkit_tpu_torch.mesh import kafka_wire as port_wire
from calfkit_tpu_torch.mesh import tcp as port_tcp
from tests._torch_rebind import ported_module
from tests.test_torch_agent_mesh import (
    ROOTS,
    _parsed,
    by_key,
    fresh_run_stores,
    history,
    pkg,
    recording,
    seeded_ids,
    weather_tool,
    worker,
)

# contract module -> {suite class: cases}
SUITES = {
    "tests.test_tcp_mesh": {
        "TestTransportSemantics": 3, "TestEndToEndOverMeshd": 1, "TestSpawnPortZero": 1},
    "tests.test_meshd_barrage": {"TestMeshdBarrage": 3},
    "tests.test_kafka_wire": {"TestWireCodec": 11, "TestWireBroker": 5, "TestConfig4MultiAgent": 1},
    "tests.test_wire_routing": {"TestLeaderRouting": 5, "TestCoordinatorRouting": 2},
    "tests.test_wire_robustness": {
        "TestRoundTrips": 2, "TestForwardCompat": 3, "TestToolReturnContentShapes": 1},
    "tests.test_wire_recovery": {
        "TestTapRevival": 1, "TestPoisonBatch": 1, "TestHeartbeatRejoin": 1,
        "TestSpawnDeadline": 2},
    "tests.test_kafka_security": {
        "TestWireSecurityParsing": 9, "TestScramVectors": 4, "TestSaslPlainAgainstKafkad": 4,
        "TestTlsRoundTrip": 2, "TestScramAgainstIndependentServer": 2},
    "tests.test_kafka_codec_fuzz": {
        "TestRoundTripProperties": 6, "TestCorruption": 4, "TestCompression": 6,
        "TestLegacyFormats": 1, "TestBrokerBarrage": 2},
    "tests.test_broker_restart": {"TestOffsetBeyondLog": 1, "TestBrokerRestart": 5},
    "tests.test_provisioning": {
        "TestClassificationOrdering": 2, "TestTopicDerivation": 2, "TestProvisionSurface": 3},
    "tests.test_connection_hardening": {
        "TestConnectionProfile": 10, "TestClassification": 4, "TestProvisionRetry": 4,
        "TestReviewRegressions": 3},
}


# --------------------------------------------------------------------------- #
# the cases of the suites
# --------------------------------------------------------------------------- #


def _param_sets(method) -> "list[tuple[str, dict]]":
    """(id, arguments) for each parameter set of ``method``'s parametrize
    marks; one empty set when it has none."""
    sets = [("", {})]
    for mark in getattr(method, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        grown = []
        for label, args in sets:
            for value in values:
                value = value.values if hasattr(value, "values") and hasattr(value, "marks") else value
                row = dict(zip(names, value if len(names) > 1 else [value]))
                grown.append((f"{label}-{'-'.join(map(str, row.values()))}", {**args, **row}))
        sets = grown
    return sets


CASES = [
    (module_name, suite_name, name, label, args)
    for module_name, suites in SUITES.items()
    for suite_name in suites
    for name, method in sorted(vars(getattr(importlib.import_module(module_name), suite_name))
                               .items())
    if name.startswith("test_")
    for label, args in _param_sets(method)
]


def _case_id(case) -> str:
    module_name, suite_name, name, label, _ = case
    return f"{module_name.rsplit('.', 1)[1]}.{suite_name}.{name}{label}"


# --------------------------------------------------------------------------- #
# fixtures: every broker on port 0
# --------------------------------------------------------------------------- #


def _stop(proc) -> None:
    proc.terminate()
    proc.wait(timeout=5)


@pytest.fixture(scope="module")
def module_brokers():
    """Brokers a suite shares across its cases (its module- or class-scoped
    fixtures), spawned at first use, one set per suite."""
    procs: dict = {}

    def get(key, spawn):
        if key not in procs:
            procs[key] = spawn()
        return procs[key]

    yield get
    for proc in procs.values():
        _stop(proc)


def _function_broker(request, spawn):
    proc = spawn()
    request.addfinalizer(lambda: _stop(proc))
    return proc


def _make_mesh(request, port: int):
    meshes = []

    async def make():
        mesh = port_tcp.TcpMesh(f"127.0.0.1:{port}")
        await mesh.start()
        meshes.append(mesh)
        return mesh

    return make


def _fixture(request, module_name: str, suite_name: str, name: str):
    """The value of the suite's fixture ``name`` for one case."""
    short = module_name.rsplit(".", 1)[1]
    shared = request.getfixturevalue("module_brokers")
    if short == "test_tcp_mesh" and name == "make_mesh":
        proc = shared(short, lambda: port_tcp.spawn_meshd(0))
        return _make_mesh(request, proc.meshd_port)
    if short == "test_meshd_barrage" and name == "broker_port":
        return _function_broker(request, lambda: port_tcp.spawn_meshd(0)).meshd_port
    if short == "test_kafka_wire" and name == "broker_port":
        return shared(short, lambda: port_wire.spawn_kafkad(0)).kafkad_port
    if short == "test_kafka_codec_fuzz" and name == "broker_port":
        return _function_broker(request, lambda: port_wire.spawn_kafkad(0)).kafkad_port
    if short == "test_kafka_security" and name == "sasl_broker":
        return shared((short, suite_name),
                      lambda: port_wire.spawn_kafkad(0, sasl="alice:secret")).kafkad_port
    if name in ("tmp_path", "caplog", "monkeypatch"):
        return request.getfixturevalue(name)
    raise LookupError(f"{short}.{suite_name} asks for an unknown fixture {name!r}")


# --------------------------------------------------------------------------- #
# the cases
# --------------------------------------------------------------------------- #


def test_the_contract_is_the_reference_suites():
    for module_name, suites in SUITES.items():
        module = importlib.import_module(module_name)
        found = {n for n, obj in vars(module).items()
                 if n.startswith("Test") and inspect.isclass(obj)}
        assert found == set(suites), module_name
    counts: dict = {}
    for module_name, suite_name, *_ in CASES:
        counts.setdefault(module_name, {}).setdefault(suite_name, 0)
        counts[module_name][suite_name] += 1
    assert counts == SUITES
    assert len(CASES) == 117
    # the rebound globals are the port's
    g = ported_module("tests.test_kafka_wire")
    assert g["KafkaWireMesh"] is port_wire.KafkaWireMesh
    assert g["crc32c"] is port_wire.crc32c
    assert ported_module("tests.test_tcp_mesh")["TcpMesh"] is port_tcp.TcpMesh
    g = ported_module("tests.test_connection_hardening")
    assert g["ProvisioningError"].__module__ == "calfkit_tpu_torch.exceptions"
    assert g["provision"].__module__ == "calfkit_tpu_torch.provisioning.provisioner"


def test_imports_inside_a_test_body_resolve_to_the_port():
    g = ported_module("tests.test_tcp_mesh")
    code = compile("from calfkit_tpu.worker import Worker\nimport calfkit_tpu.client as c\n",
                   "<case>", "exec")
    scope: dict = {"__builtins__": g["__builtins__"]}
    exec(code, scope)
    assert scope["Worker"].__module__ == "calfkit_tpu_torch.worker.worker"
    assert scope["c"].__name__ == "calfkit_tpu_torch.client"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_transport_contract_on_the_port(case, request):
    module_name, suite_name, name, _, args = case
    g = ported_module(module_name)
    suite = g[suite_name]
    method = vars(suite)[name]
    assert method.__globals__ is g
    params = [p for p in inspect.signature(method).parameters if p != "self"]
    kwargs = {p: args[p] if p in args else _fixture(request, module_name, suite_name, p)
              for p in params}
    result = method(suite(), **kwargs)
    if inspect.isawaitable(result):
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(asyncio.wait_for(result, timeout=60))
        finally:
            loop.close()


# --------------------------------------------------------------------------- #
# interop: the two packages on one broker
# --------------------------------------------------------------------------- #


def _spawn(kind: str):
    if kind == "kafkad":
        proc = port_wire.spawn_kafkad(0)
        return proc, f"127.0.0.1:{proc.kafkad_port}"
    proc = port_tcp.spawn_meshd(0)
    return proc, f"127.0.0.1:{proc.meshd_port}"


def _mesh(P, kind: str, address: str):
    root = importlib.import_module(f"{ROOTS[P.name]}.mesh")
    return root.KafkaWireMesh(address) if kind == "kafkad" else root.TcpMesh(address)


async def interop_turn(kind: str, client_pkg: str, worker_pkg: str) -> dict:
    """The quickstart's turn: ``worker_pkg``'s Worker serves the agent and
    its tool on a fresh broker, ``client_pkg``'s Client calls it over its
    own connection; every record either side publishes is logged."""
    W, C = pkg(worker_pkg), pkg(client_pkg)
    fresh_run_stores()
    proc, address = _spawn(kind)
    log: list = []
    try:
        with seeded_ids():
            get_weather = weather_tool(W)
            agent = W.Agent(
                "weather_agent",
                model=W.engine.TestModelClient(custom_output_text="It is sunny in SF, 21.5C"),
                instructions="You are a weather assistant.", tools=[get_weather],
            )
            worker_mesh, client_mesh = _mesh(W, kind, address), _mesh(C, kind, address)
            recording(worker_mesh, log)
            recording(client_mesh, log)
            async with worker(W, [agent, get_weather], worker_mesh):
                client = C.Client.connect(client_mesh)
                handle = await client.agent("weather_agent").start("Weather in SF?", timeout=20)
                events = [e async for e in handle.stream()]
                await client.close()
                await client_mesh.stop()
    finally:
        _stop(proc)
    result = events[-1]
    assert isinstance(result, C.InvocationResult), result
    return {
        "output": result.output,
        "history": history(result),
        "kinds": [e.step.kind for e in events if hasattr(e, "step")],
        "records": [(topic, key, _parsed(value)) for topic, key, value in log],
    }


_REFERENCE_RUNS: dict = {}


@pytest.mark.parametrize("kind", ["kafkad", "meshd"])
@pytest.mark.parametrize("client_pkg, worker_pkg", [("ref", "port"), ("port", "ref")],
                         ids=["ref-client-port-worker", "port-client-ref-worker"])
async def test_interop_matches_an_all_reference_run(kind, client_pkg, worker_pkg):
    if kind not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[kind] = await interop_turn(kind, "ref", "ref")
    ref = _REFERENCE_RUNS[kind]
    mixed = await interop_turn(kind, client_pkg, worker_pkg)
    assert ref["output"] == "It is sunny in SF, 21.5C"
    assert ref["records"], "the drive published nothing"
    for key in ("output", "history", "kinds"):
        assert mixed[key] == ref[key], key
    assert len(mixed["records"]) == len(ref["records"])
    assert by_key(mixed["records"]) == by_key(ref["records"])


def test_keys_land_on_the_reference_partitions():
    """Both packages may share one topic: the port's partitioner puts every
    key where the JAX package's does."""
    import random

    from calfkit_tpu.mesh import kafka_wire as ref_wire

    rng = random.Random(7)
    for _ in range(500):
        key = rng.randbytes(rng.randrange(0, 40))
        n = rng.choice([1, 3, 8, 16])
        assert port_wire.murmur2(key) == ref_wire.murmur2(key)
        assert port_wire.partition_for(key, n, [0]) == ref_wire.partition_for(key, n, [0])


def test_native_targets_follow_the_makefile():
    """``_native.TARGETS`` copies ``native/Makefile``'s three rules (the
    Makefile writes into ``native/bin/``, which the port's builds leave
    alone): each target's source, compiler and flag variables and extra
    flags are the rule's, and the targets are the ones ``all`` builds."""
    import re

    from calfkit_tpu_torch.mesh import _native

    text = (_native.NATIVE_DIR / "Makefile").read_text()
    rules = {}
    for m in re.finditer(r"^bin/(\S+): (\S+)\n((?:\t.*\n)+)", text, re.M):
        compile_line = [ln.strip() for ln in m[3].splitlines() if "-o $@ $<" in ln]
        assert len(compile_line) == 1, m[0]
        words = compile_line[0].split()
        assert words[-3:] == ["-o", "$@", "$<"], words
        cc, flags = (re.fullmatch(r"\$\((\w+)\)", w)[1] for w in words[:2])
        rules[m[1]] = (m[2], cc, flags, tuple(words[2:-3]))
    all_targets = re.search(r"^all: (.*)$", text, re.M)[1].split()
    assert sorted(f"bin/{n}" for n in rules) == sorted(all_targets)
    assert {n: t[:4] for n, t in _native.TARGETS.items()} == rules
    assert {cc for _, cc, flags, _ in rules.values()} | \
        {flags for _, _, flags, _ in rules.values()} <= set(_native.makefile_defaults())
