"""The serving fleet of the JAX package's suites, held against the port, and
the two packages' fleets side by side.

**The reference suites, rebound.**  The cases of ``tests/test_fleet.py``
(selection primitives, policies, the replica registry, the router, the
failure-recovery and caller-liveness laws), of
``tests/test_fleet_kafkad.py::TestFleetSoakOverKafka`` (drain, staleness,
shed retries and a kill over the Kafka wire, on a ``kafkad`` this file
spawns on port 0) and the stub-backed cases of
``tests/test_chaos.py::TestFailoverChaos`` run here unchanged against
``calfkit_tpu_torch``, one parametrised case a test, each suite rebound by
``tests/_torch_rebind.py``: its ``calfkit_tpu`` names are the port's, and
the harness it takes from ``tests._chaos`` (``FleetTopology``,
``ServingStubModel``, ``settle``, ``virtual_clock``, ...) is the port's
``calfkit_tpu_torch.sim``; the four cases that render through ``cli.obs``
(``render_fleet_table``, ``render_leases_table``) run on the port's
``calfkit_tpu_torch.cli.obs``.

**The engine-backed chaos cases** (drain handoff and shed retries of
``TestFleetChaos``, ``TestFailoverChaos::test_kill_mid_run_real_engines_no_leaks``
and ``TestDecodeFromOffsetResume::test_kill_mid_stream_resume_rides_survivor``)
run rebound too, with the suite's engine and model client replaced by the
port's on the CPU (``InferenceEngine(..., device="cpu")``,
``TorchLocalModelClient``) over the reference's debug-preset weights
converted by ``tests/_torch_port.py``.

**Two packages, one answer.**  From numpy-seeded inputs: the hashes, ranks
and prefix keys of ``fleet.selection``; every policy's pick over the same
replica set, loads and seed; ``StreamLedger``'s output over the same chunk
and offset sequence; and two-replica fleets of each package on the same
weights, which place the same prompts on the same replicas and answer with
the same greedy text.
"""

from __future__ import annotations

import asyncio
import functools
import importlib
import inspect

import pytest

from calfkit_tpu_torch.mesh import kafka_wire as port_wire
from tests._torch_rebind import Absent, ported_module

# contract module -> {suite class: cases rebound}
SUITES = {
    "tests.test_fleet": {
        "TestSelectionPrimitives": 5, "TestPolicies": 12, "TestReplicaRegistry": 3,
        "TestFleetRouter": 4, "TestFleetCli": 5, "TestFailureRecoveryLaws": 5,
        "TestCallerLivenessLaws": 6},
    "tests.test_fleet_kafkad": {"TestFleetSoakOverKafka": 4},
    "tests.test_chaos": {"TestFailoverChaos": 5},
}
# the cases run apart, and why
LEFT_OUT = {
    # the engine-backed cases run below, on the port's CPU engines
    ("tests.test_chaos", "TestFailoverChaos", "test_kill_mid_run_real_engines_no_leaks"):
        "engine",
}
ENGINE_CASES = [
    ("TestFleetChaos", "test_draining_replica_gets_zero_new_calls"),
    ("TestFleetChaos", "test_shed_retried_on_a_different_replica"),
    ("TestFailoverChaos", "test_kill_mid_run_real_engines_no_leaks"),
    ("TestDecodeFromOffsetResume", "test_kill_mid_stream_resume_rides_survivor"),
]

CASES = [
    (module_name, suite_name, name)
    for module_name, suites in SUITES.items()
    for suite_name in suites
    # definition order: the Kafka soak shares one broker across its cases,
    # and its kill case (last) leaves the corpse's advert on the table
    for name in vars(getattr(importlib.import_module(module_name), suite_name))
    if name.startswith("test_") and (module_name, suite_name, name) not in LEFT_OUT
]


def _run(result, timeout: float = 120) -> None:
    if inspect.isawaitable(result):
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(asyncio.wait_for(result, timeout=timeout))
        finally:
            loop.close()


@pytest.fixture(scope="module")
def kafkad_port():
    proc = port_wire.spawn_kafkad(0)
    yield proc.kafkad_port
    proc.terminate()
    proc.wait(timeout=5)


def _fixture(request, module_name: str, name: str):
    if name == "broker_port" and module_name == "tests.test_fleet_kafkad":
        return request.getfixturevalue("kafkad_port")
    if name == "params" and module_name == "tests.test_chaos":
        return None  # the stub-backed cases take no weights
    if name == "monkeypatch":
        return request.getfixturevalue(name)
    raise LookupError(f"{module_name} asks for an unknown fixture {name!r}")


def test_the_contract_is_the_reference_suites():
    counts: dict = {}
    for module_name, suite_name, _ in CASES:
        counts.setdefault(module_name, {}).setdefault(suite_name, 0)
        counts[module_name][suite_name] += 1
    assert counts == SUITES
    assert len(CASES) == 49
    for module_name, suite_name, name in LEFT_OUT:
        assert name in vars(getattr(importlib.import_module(module_name), suite_name))
    # the rebound globals are the port's, the chaos harness included
    g = ported_module("tests.test_fleet")
    from calfkit_tpu_torch import fleet, sim

    for name in ("FleetRouter", "PrefixAffinity", "ReplicaRegistry", "affinity_key_for"):
        assert g[name] is getattr(fleet, name), name
    for name in ("FleetTopology", "ServingStubModel", "settle", "virtual_clock"):
        assert g[name] is getattr(sim, name), name
    from calfkit_tpu_torch.cli import obs

    assert g["render_fleet_table"] is obs.render_fleet_table
    assert not any(isinstance(value, Absent) for value in g.values())


def test_chaos_imports_inside_a_test_body_resolve_to_the_port():
    g = ported_module("tests.test_chaos")
    scope: dict = {"__builtins__": g["__builtins__"]}
    exec(compile("from tests._chaos import StreamingStubModel, BijectiveTokenizer\n"
                 "from calfkit_tpu.fleet import FailoverPolicy\n", "<case>", "exec"), scope)
    assert scope["StreamingStubModel"].__module__ == "calfkit_tpu_torch.sim.stubs"
    assert scope["BijectiveTokenizer"].__module__ == "calfkit_tpu_torch.sim.stubs"
    assert scope["FailoverPolicy"].__module__ == "calfkit_tpu_torch.fleet.failover"


@pytest.mark.parametrize("case", CASES, ids=[f"{m.rsplit('.', 1)[1]}.{s}.{n}" for m, s, n in CASES])
def test_fleet_contract_on_the_port(case, request):
    module_name, suite_name, name = case
    g = ported_module(module_name)
    suite = g[suite_name]
    method = vars(suite)[name]
    assert method.__globals__ is g
    params = [p for p in inspect.signature(method).parameters if p != "self"]
    kwargs = {p: _fixture(request, module_name, p) for p in params}
    _run(method(suite(), **kwargs))


# --------------------------------------------------------------------------- #
# the engine-backed chaos cases, on the port's CPU engines
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=1)
def _weights():
    from tests._torch_port import jax_params, torch_params

    return torch_params(jax_params(0))


def _engine_suite() -> dict:
    """``tests/test_chaos.py`` rebound with the port's engine and model
    client on the CPU (the suite builds them by the reference's names)."""
    from calfkit_tpu_torch.inference import TorchLocalModelClient
    from calfkit_tpu_torch.inference.config import preset
    from calfkit_tpu_torch.inference.engine import InferenceEngine

    return ported_module("tests.test_chaos", variant="cpu-engines", overrides={
        "CFG": preset("debug"),
        "InferenceEngine": functools.partial(InferenceEngine, device="cpu"),
        "JaxLocalModelClient": functools.partial(TorchLocalModelClient, device="cpu"),
    })


@pytest.mark.parametrize("case", ENGINE_CASES, ids=[f"{s}.{n}" for s, n in ENGINE_CASES])
def test_engine_fleet_chaos_on_the_port(case):
    suite_name, name = case
    g = _engine_suite()
    assert g["CFG"].__class__.__module__.startswith("calfkit_tpu_torch.")
    suite = g[suite_name]
    _run(vars(suite)[name](suite(), _weights()), timeout=240)


# --------------------------------------------------------------------------- #
# two packages, one answer
# --------------------------------------------------------------------------- #


def _packages():
    import calfkit_tpu.fleet as ref_fleet
    import calfkit_tpu.fleet.selection as ref_sel
    import calfkit_tpu.models.records as ref_records
    import calfkit_tpu_torch.fleet as port_fleet
    import calfkit_tpu_torch.fleet.selection as port_sel
    import calfkit_tpu_torch.models.records as port_records

    return {"ref": (ref_fleet, ref_sel, ref_records), "port": (port_fleet, port_sel, port_records)}


def _text(rng, n: int) -> str:
    return "".join(chr(c) for c in rng.integers(32, 0x2FF, size=n))


def test_hashes_ranks_and_prefix_keys_equal_the_reference():
    import numpy as np

    (_, ref, _), (_, port, _) = _packages()["ref"], _packages()["port"]
    rng = np.random.default_rng(14)
    for _ in range(300):
        data = rng.bytes(int(rng.integers(0, 200)))
        salt = _text(rng, int(rng.integers(0, 120))).encode()
        assert port.stable_hash(data, salt=salt) == ref.stable_hash(data, salt=salt)
        assert port.lane_of(data, 7) == ref.lane_of(data, 7)
        ids = [f"agent.svc@{_text(rng, int(rng.integers(1, 80)))}"
               for _ in range(int(rng.integers(1, 9)))]
        assert port.rendezvous_rank(data, ids) == ref.rendezvous_rank(data, ids)
        page, pages = int(rng.integers(0, 70)), int(rng.integers(0, 6))
        text = _text(rng, int(rng.integers(0, 400)))
        tokens = [int(t) for t in rng.integers(-5, 130000, size=int(rng.integers(0, 200)))]
        for prompt in (text, tokens):
            assert (port.page_aligned_prefix(prompt, page, max_pages=pages)
                    == ref.page_aligned_prefix(prompt, page, max_pages=pages))
    assert port.lane_of(None, 5) == ref.lane_of(None, 5) == 0


def _replica_set(P, rng, n: int) -> list:
    fleet, _, records = P
    out = []
    for i in range(n):
        instance = f"i{int(rng.integers(0, 10**6)):06d}"
        stats = records.EngineStatsRecord(
            node_id="agent.svc", model_name="m8b", instance_id=instance,
            replica_topic=f"agent.svc.replica.{instance}",
            active_requests=int(rng.integers(0, 4)), pending_requests=int(rng.integers(0, 3)),
            batch_pending=int(rng.integers(0, 2)),
            dispatch_ewma_ms=float(rng.choice([0.0, 3.0, 5.5, 9.0])),
        )
        out.append(fleet.Replica(key=f"agent.svc@{instance}", node_id="agent.svc",
                                 instance_id=instance, heartbeat_at=1.0, stats=stats,
                                 router_inflight=int(rng.integers(0, 2))))
    return out


def test_policy_picks_equal_the_reference():
    """The same replica set, loads and seed: every policy picks the same
    replica in both packages (seeded ``random.Random`` draws included)."""
    import random

    import numpy as np

    packages = _packages()
    for seed in range(60):
        n = 1 + seed % 6
        prompt = _text(np.random.default_rng(seed), 40 + 7 * seed)
        picks = {}
        for name, P in packages.items():
            fleet = P[0]
            candidates = _replica_set(P, np.random.default_rng(seed), n)
            request = fleet.RouteRequest(agent="svc", affinity_key=fleet.affinity_key_for(prompt))
            # PrefixAffinity's default fallback (a prompt under one affinity
            # page) draws from the module's global generator
            random.seed(seed)
            picks[name] = [
                policy.select(candidates, request).key for policy in (
                    fleet.LeastLoaded(),
                    fleet.PowerOfTwoChoices(rng=random.Random(seed).random),
                    fleet.RandomChoice(rng=random.Random(seed).random),
                    fleet.PrefixAffinity(),
                    fleet.PrefixAffinity(fallback=fleet.RandomChoice(rng=random.Random(seed).random)),
                    fleet.resolve_policy("least-loaded"),
                )
            ]
        assert picks["port"] == picks["ref"], seed


def test_stream_ledger_output_equals_the_reference():
    """The same chunk and offset sequence, with failovers between: both
    packages' ledgers deliver the same text, chunk by chunk."""
    import numpy as np

    packages = _packages()
    for seed in range(80):
        rng = np.random.default_rng(seed)
        answer = _text(rng, 60)
        events = []
        for _ in range(int(rng.integers(1, 4))):  # attempts
            at = int(rng.integers(0, 20)) if events else 0
            stamped = bool(rng.integers(0, 2))
            while at < len(answer):
                size = int(rng.integers(1, 9))
                events.append(("chunk", answer[at:at + size], at if stamped else None))
                at += size
                if rng.random() < 0.15:
                    break
            events.append(("begin", None, None))
        outputs = {}
        for name, (fleet, _, _) in packages.items():
            ledger = fleet.StreamLedger()
            out = []
            for kind, chunk, offset in events:
                if kind == "begin":
                    ledger.begin_attempt()
                else:
                    out.append(ledger.filter(chunk, offset))
            outputs[name] = (out, ledger.text, ledger.delivered)
        assert outputs["port"] == outputs["ref"], seed


# two prompts homed on each pinned replica by prefix affinity
FLEET_PROMPTS = [
    f"Conversation {i}: plan a weekend trip along the coast, list three stops and a meal."
    for i in (0, 1, 2, 7)
]
FLEET_RT = dict(
    max_batch_size=2, max_seq_len=1024, prefill_chunk=16, decode_steps_per_dispatch=4,
    kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True,
)


def _fleet_models(name: str, weights, n: int = 2) -> "tuple[list, list]":
    from tests._torch_port import JAX_CFG, TORCH_CFG, JaxEngine, JaxRuntime, TorchRuntime
    from tests._torch_port import InferenceEngine as PortEngine

    engines, models = [], []
    for _ in range(n):
        if name == "ref":
            from calfkit_tpu.inference.client import JaxLocalModelClient

            engine = JaxEngine(JAX_CFG, JaxRuntime(**FLEET_RT, attention_impl="pallas_interpret"),
                               params=weights[0])
            models.append(JaxLocalModelClient(config=JAX_CFG, engine=engine, max_new_tokens=12))
        else:
            from calfkit_tpu_torch.inference import TorchLocalModelClient

            engine = PortEngine(TORCH_CFG, TorchRuntime(**FLEET_RT), params=weights[1],
                                device="cpu")
            models.append(TorchLocalModelClient(engine=engine, max_new_tokens=12))
        engines.append(engine)
    return engines, models


async def _fleet_drive(name: str, weights) -> dict:
    """Two pinned replicas (``r0``, ``r1``) of one agent behind a
    prefix-affinity router with failover: each prompt executed once, then
    the first prompt streamed; which replica served each call, the
    answers, the stream's token texts and offsets."""
    root = {"ref": "calfkit_tpu", "port": "calfkit_tpu_torch"}[name]
    sim = importlib.import_module(f"{root}.sim")
    fleet_mod = importlib.import_module(f"{root}.fleet")
    client_mod = importlib.import_module(f"{root}.client")
    mesh_mod = importlib.import_module(f"{root}.mesh")
    result_type = importlib.import_module(f"{root}.models.node_result").InvocationResult
    engines, models = _fleet_models(name, weights)
    out: dict = {"placements": [], "answers": [], "tokens": [], "offsets": []}
    with sim.virtual_clock():
        mesh = mesh_mod.InMemoryMesh()
        fleet = sim.FleetTopology(mesh, models, agent_kwargs={"stream_tokens": True})
        for i, agent in enumerate(fleet.agents):
            agent.instance_id = f"r{i}"
        async with fleet:
            router = fleet_mod.FleetRouter(mesh, "prefix-affinity",
                                           stale_after=fleet.config.stale_after)
            client = client_mod.Client.connect(
                mesh, router=router, failover=fleet_mod.FailoverPolicy(probe_interval=0.05))
            await router.start()
            await sim.settle(lambda: len(router.registry.eligible("svc")) == 2,
                             message="fleet never became routable")
            for prompt in FLEET_PROMPTS:
                before = [fleet.calls_delivered(i) for i in range(2)]
                result = await client.agent("svc").execute(prompt, timeout=120)
                grew = [i for i in range(2) if fleet.calls_delivered(i) > before[i]]
                out["placements"].append([fleet.instance_id(i) for i in grew])
                out["answers"].append(result.output)
                out["policy"] = out.get("policy", []) + [
                    router.select("svc", prompt_text=prompt).instance_id]
            async for item in client.agent("svc").stream(FLEET_PROMPTS[0], timeout=120):
                if isinstance(item, result_type):
                    out["streamed"] = item.output
                elif getattr(item.step, "kind", "") == "token":
                    out["tokens"].append(item.step.text)
                    out["offsets"].append(item.step.offset)
            await client.close()
        for engine in engines:
            await engine.stop()
        await mesh.stop()
    return out


async def test_two_packages_fleets_place_and_answer_alike():
    from tests._torch_port import jax_params, torch_params

    p = jax_params(0)
    weights = (p, torch_params(p))
    ref = await _fleet_drive("ref", weights)
    port = await _fleet_drive("port", weights)
    # every call placed once, on its prefix-affinity home, both replicas used
    assert ref["placements"] == [[r] for r in ref["policy"]]
    assert sorted({r for [r] in ref["placements"]}) == ["r0", "r1"]
    assert port == ref
    assert all(ref["answers"]) and "".join(ref["tokens"]) == ref["streamed"] == ref["answers"][0]
