"""The ``ck`` command of the JAX package's suites, held against the port, and
the two packages' command lines and renderers side by side.

**The reference suites, rebound.**  The cases of ``tests/test_cli_dev.py``
(the ``--reload`` watcher, the connect-or-spawn broker lock raced by four
threads, detached daemons, bare-file node specs, the managed ``kafkad``
and its durable WAL), ``tests/test_chat_cli.py`` (the REPL's rendering and
history) and ``tests/test_runledger.py`` (the run header, the ledger, the
rollups, the run timeline's parse and stitch, and a failover run end to
end) run here unchanged against ``calfkit_tpu_torch``, one parametrised
case a test (a parametrised test gives one case a parameter set), each
suite rebound by ``tests/_torch_rebind.py``: its ``calfkit_tpu`` names are
the port's, and ``click.ClickException`` in a test body is the port's
``CliError``.  ``tests/test_cli_dev.py``'s node files name the port's
modules (every ``calfkit_tpu`` in its strings is rewritten), and its fixed
broker ports move by 10,000 (``PORTS``), since its own file runs beside
this one and the port's ``ck dev`` keeps its state apart from the JAX
package's (``~/.calfkit_tpu_torch/dev``).

**Two command lines, one grammar.**  The reference's click tree, walked:
every command and group has the port's counterpart of the same name, with
the same arguments (name, count, required) and options (flag, parameter,
default, type, flag-ness); the same argument lists parse to the same
values in both; and ``ck`` lines run through both print the same text and
exit with the same code.

**Two packages, one text.**  Every renderer of ``cli/obs.py`` and
``cli/sim.py`` prints, from records built by the same seeded generator in
both packages, exactly the reference's text.
"""

from __future__ import annotations

import asyncio
import builtins
import importlib
import inspect
import json

import numpy as np
import pytest

from tests._torch_rebind import Absent, ported_module

# contract module -> {suite class: cases rebound}
SUITES = {
    "tests.test_cli_dev": {
        "TestReload": 3, "TestBrokerLock": 2, "TestDaemons": 1, "TestBareFileSpecs": 6,
        "TestKafkadDevBroker": 2, "TestDurableDevBroker": 2},
    "tests.test_chat_cli": {"TestRepl": 3},
    "tests.test_runledger": {
        "TestRunHeaderLaws": 13, "TestRunLedgerUnit": 5, "TestRollupLaws": 4,
        "TestRunRenderers": 4, "TestRunLedgerE2E": 3},
}
# tests/test_cli_dev.py's fixed broker ports -> the rebound suite's
PORTS = {19878: 29878, 19393: 29393, 19394: 29394, 19893: 29893, 19894: 29894}


def _param_sets(method) -> "list[tuple[str, dict]]":
    """(id, arguments) for each parameter set of ``method``'s parametrize
    marks; one empty set when it has none."""
    sets = [("", {})]
    for mark in getattr(method, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        sets = [(f"{label}-{value!r}", {**args, **dict(zip(names, [value]))})
                for label, args in sets for value in mark.args[1]]
    return sets


CASES = [
    (module_name, suite_name, name, label, args)
    for module_name, suites in SUITES.items()
    for suite_name in suites
    for name, method in vars(getattr(importlib.import_module(module_name), suite_name)).items()
    if name.startswith("test_")
    for label, args in _param_sets(method)
]


def _suite(module_name: str) -> dict:
    if module_name == "tests.test_cli_dev":
        return ported_module(module_name, sources=True, constants=PORTS,
                             overrides={"PORT": PORTS[19878]})
    return ported_module(module_name)


def test_the_contract_is_the_reference_suites():
    counts: dict = {}
    for module_name, suite_name, *_ in CASES:
        counts.setdefault(module_name, {}).setdefault(suite_name, 0)
        counts[module_name][suite_name] += 1
    assert counts == SUITES
    assert len(CASES) == 48
    for module_name in SUITES:
        module = importlib.import_module(module_name)
        own = {name for name, obj in vars(module).items() if isinstance(obj, type)
               and name.startswith("Test") and obj.__module__ == module_name}
        assert own == set(SUITES[module_name]), module_name
        g = _suite(module_name)
        assert not any(isinstance(value, Absent) for value in g.values()), module_name
    from calfkit_tpu_torch.cli import chat, obs

    assert _suite("tests.test_chat_cli")["repl"] is chat.repl
    assert _suite("tests.test_runledger")["render_run_timeline"] is obs.render_run_timeline
    g = _suite("tests.test_cli_dev")
    assert g["PORT"] == 29878
    scope: dict = {"__builtins__": g["__builtins__"]}
    exec("import click\nfrom calfkit_tpu.cli._dev_state import dev_dir\n", scope)
    from calfkit_tpu_torch.cli import _common, _dev_state

    assert scope["click"].ClickException is _common.CliError
    assert scope["dev_dir"] is _dev_state.dev_dir


@pytest.fixture
def scripted_input(monkeypatch):
    """``tests/test_chat_cli.py``'s fixture: feed the REPL a list of
    prompts, then EOF."""

    def feed(*prompts: str):
        it = iter(prompts)

        def fake_input(_prompt: str = "") -> str:
            try:
                return next(it)
            except StopIteration:
                raise EOFError

        monkeypatch.setattr(builtins, "input", fake_input)

    return feed


def _fixture(request, name: str):
    if name == "dev_env":  # tests/test_cli_dev.py's: a dev dir of the test's own
        tmp_path = request.getfixturevalue("tmp_path")
        request.getfixturevalue("monkeypatch").setenv("CALFKIT_DEV_DIR",
                                                      str(tmp_path / "devstate"))
        return tmp_path
    return request.getfixturevalue(name)


@pytest.mark.parametrize("case", CASES, ids=[
    f"{m.rsplit('.', 1)[1]}.{s}.{n}{label}" for m, s, n, label, _ in CASES])
def test_cli_contract_on_the_port(case, request):
    module_name, suite_name, name, _, args = case
    g = _suite(module_name)
    suite = g[suite_name]
    method = vars(suite)[name]
    assert method.__globals__ is g
    params = [p for p in inspect.signature(method).parameters if p != "self"]
    kwargs = {p: args[p] if p in args else _fixture(request, p) for p in params}
    result = method(suite(), **kwargs)
    if inspect.isawaitable(result):
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(asyncio.wait_for(result, timeout=120))
        finally:
            loop.close()


# --------------------------------------------------------------------------- #
# two command lines, one grammar
# --------------------------------------------------------------------------- #


def _tree(command, path=()):
    """(path, command) for ``command`` and everything under it."""
    yield path, command
    for name, sub in getattr(command, "commands", {}).items():
        yield from _tree(sub, (*path, name))


def _trees():
    from calfkit_tpu.cli.main import main as ref_main
    from calfkit_tpu_torch.cli.main import main as port_main

    return dict(_tree(ref_main)), dict(_tree(port_main))


def _leaves():
    import click

    ref, _ = _trees()
    return [path for path, command in ref.items() if not isinstance(command, click.Group)]


def test_ck_has_the_reference_commands():
    import click

    from calfkit_tpu_torch.cli._common import Group

    ref, port = _trees()
    assert list(ref) == list(port)
    for path, command in ref.items():
        assert isinstance(command, click.Group) == isinstance(port[path], Group), path
    assert port[()].version == importlib.import_module("calfkit_tpu").__version__


def _click_type(param) -> type:
    import click

    kinds = ((click.types.IntParamType, int), (click.types.FloatParamType, float),
             (click.types.BoolParamType, bool))
    return next((kind for cls, kind in kinds if isinstance(param.type, cls)), str)


def _argv(path, ref_command, given: bool) -> "list[str]":
    """A command line for ``path``: its arguments filled, and with
    ``given`` every option too (flags set, values of the option's type)."""
    import click

    argv = list(path)
    for param in ref_command.params:
        if isinstance(param, click.Argument):
            argv += ["a1", "a2"] if param.nargs == -1 else ["a1"]
        elif given:
            argv += [param.opts[0]] if param.is_flag else [
                param.opts[0], {int: "7", float: "2.5", str: "x"}[_click_type(param)]]
    return argv


@pytest.mark.parametrize("path", _leaves(), ids=" ".join)
def test_options_and_defaults_equal_the_reference(path):
    """Each command's parameters against the reference's, one by one, and
    the same command lines (arguments only; every option given) parsed by
    click and by the port to the same values."""
    import click

    from calfkit_tpu_torch.cli._common import Argument

    ref, port = _trees()
    ref_command, port_command = ref[path], port[path]
    by_name = {p.name: p for p in port_command.params}
    assert [p.name for p in port_command.params] == [p.name for p in ref_command.params]
    for param in ref_command.params:
        mine = by_name[param.name]
        if isinstance(param, click.Argument):
            assert isinstance(mine, Argument)
            assert (mine.nargs, mine.required) == (param.nargs, param.required), param.name
        else:
            assert [mine.flag] == param.opts and not param.secondary_opts, param.name
            assert mine.is_flag == param.is_flag, param.name
            assert mine.default == param.default, param.name
            assert mine.type is _click_type(param), param.name
            assert mine.show_default == bool(param.show_default), param.name
    main = port[()]
    for given in (False, True):
        argv = _argv(path, ref_command, given)
        want = ref_command.make_context(path[-1], argv[len(path):]).params
        command, got = main.parse(argv)
        assert command is port_command
        assert got == want, argv


def _run_both(argv, tmp_path, monkeypatch, capsys):
    """``argv`` through the reference's click ``ck`` and the port's → ((out,
    err, code), (out, err, code)), each run in ``tmp_path``."""
    from click.testing import CliRunner

    from calfkit_tpu.cli.main import main as ref_main
    from calfkit_tpu_torch.cli.main import main as port_main

    monkeypatch.chdir(tmp_path)
    result = CliRunner().invoke(ref_main, argv, prog_name="ck")
    ref = (result.stdout, result.stderr, result.exit_code)
    capsys.readouterr()
    with pytest.raises(SystemExit) as exit_:
        port_main.main(argv, prog_name="ck")
    out, err = capsys.readouterr()
    return ref, (out, err, exit_.value.code)


COMMAND_LINES = [
    ["--version"],
    ["sim"],
    ["sim", "--checks"],
    ["sim", "--scenario", "lease_churn", "--checks"],
    ["sim", "--path", "failed.json"],
    ["sim", "--path", "missing.json"],
    ["timeline", "c0ffee", "--dump", "missing.jsonl"],
    ["capacity", "--dump", "missing.jsonl"],
    ["run", "nowhere/nodes.py:agent"],
    ["topics", "provision", "nowhere_mod:x", "--dry-run"],
    ["dev", "mesh", "--durable"],
]


@pytest.mark.parametrize("argv", COMMAND_LINES, ids=" ".join)
def test_command_lines_print_and_exit_as_the_reference(argv, tmp_path, monkeypatch, capsys):
    """Whole ``ck`` lines through both packages: stdout, stderr and the exit
    code equal (SIM.json rendered as is, with a failed scenario, and
    filtered; the errors a user meets first)."""
    document = json.loads(open(_repo("SIM.json")).read())
    (tmp_path / "SIM.json").write_text(json.dumps(document))
    document["passed"] = document["scenarios"][1]["passed"] = False
    document["scenarios"][1]["checks"][0]["passed"] = False
    (tmp_path / "failed.json").write_text(json.dumps(document))
    monkeypatch.setenv("CALFKIT_DEV_DIR", str(tmp_path / "devstate"))
    ref, port = _run_both(argv, tmp_path, monkeypatch, capsys)
    assert port == ref


def _repo(name: str) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), name)


# --------------------------------------------------------------------------- #
# two packages, one text
# --------------------------------------------------------------------------- #


def _packages():
    return {name: (importlib.import_module(f"{root}.cli.obs"),
                   importlib.import_module(f"{root}.models.records"),
                   importlib.import_module(f"{root}.fleet.registry"))
            for name, root in (("ref", "calfkit_tpu"), ("port", "calfkit_tpu_torch"))}


def _record(name: str, rng, **fields) -> "tuple":
    """A record of class ``name`` from the wire generator's seeded data,
    ``fields`` over it → (the reference's, the port's)."""
    from calfkit_tpu_torch.models import records
    from tests.test_torch_wire import gen_record

    data = {**gen_record(getattr(records, name), rng), **fields}
    packages = _packages()
    return tuple(getattr(packages[p][1], name).model_validate(data) for p in ("ref", "port"))


def _outcome(fn, *args, **kwargs) -> str:
    try:
        return fn(*args, **kwargs)
    except Exception as exc:  # both packages must fail alike too
        return f"raised {type(exc).__name__}: {exc}"


def _stats_fields(rng) -> dict:
    n = lambda hi: int(rng.integers(0, hi))  # noqa: E731
    fields = dict(
        node_id=f"agent.s{n(3)}", model_name=f"m{n(2)}", instance_id=f"i{n(10**6):06d}",
        max_batch_size=n(17), free_slots=n(9), max_pending=n(3), shed_requests=n(5),
        interactive_shed=n(2) * n(3), batch_shed=n(3), pages_total=n(2) * n(600),
        pages_in_use=n(300), ready=bool(n(2)), draining=bool(n(2)), wedged=bool(n(2)),
        replica_topic=["", "agent.s.replica.x"][n(2)],
    )
    if n(2):
        fields["latency_ms"] = {"ttft_p50": float(n(900)), "ttft_p99": float(n(2000)),
                                **({"dispatch_gap_p99": n(100) / 7} if n(2) else {})}
    if n(2):
        fields["window"] = {"tokens_per_second": n(4000) / 3, "mean_occupancy": n(100) / 99,
                            **({"shed_requests": n(4), "expired_requests": n(3)} if n(2) else {})}
    if n(2):
        fields["flightrec"] = {"appended": n(10**5), "dropped": n(50)}
    return fields


SEEDS = range(6)


@pytest.mark.parametrize("seed", SEEDS)
def test_tables_equal_the_reference(seed):
    """The engine, fleet, capacity, SLO and lease tables over the same
    seeded records (a replica of each package per advert)."""
    rng = np.random.default_rng(seed)
    packages = _packages()
    stats = [_record("EngineStatsRecord", rng, **_stats_fields(rng))
             for _ in range(int(rng.integers(0, 6)))]
    slo = [_record("SloRollupRecord", rng) for _ in range(int(rng.integers(0, 5)))]
    now = 1_700_000_000.0 + float(rng.integers(0, 1000))
    beats = {f"lease-{i}": json.dumps({"lease_id": f"lease-{i}", "ttl_s": float(rng.integers(1, 30)),
                                       "beat_at": now - float(rng.integers(0, 60))}).encode()
             for i in range(int(rng.integers(0, 6)))}
    if rng.integers(0, 2):
        beats["lease-bad"] = b"not json"
    texts = {}
    for i, (name, (obs, _, registry)) in enumerate(packages.items()):
        replicas = [registry.Replica(key=f"{s[i].node_id}@{s[i].instance_id}",
                                     node_id=s[i].node_id, instance_id=s[i].instance_id,
                                     heartbeat_at=now - float(rng_i), stats=s[i],
                                     router_inflight=rng_i % 3)
                    for rng_i, s in enumerate(stats)]
        texts[name] = [
            _outcome(obs.render_stats_table, [s[i] for s in stats]),
            _outcome(obs.render_fleet_table, replicas, stale_after=2.5, now=now),
            _outcome(obs.render_capacity_table, replicas),
            _outcome(obs.render_slo_table, [r[i] for r in slo]),
            _outcome(obs.render_leases_table, beats, now=now),
        ]
    assert texts["port"] == texts["ref"]


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_and_run_timelines_equal_the_reference(seed):
    """The per-hop waterfall and the stitched run timeline over the same
    seeded spans, attempts and flight-recorder events."""
    rng = np.random.default_rng(100 + seed)
    packages = _packages()
    corrs = [f"corr{i}" for i in range(int(rng.integers(1, 4)))]
    t0 = 1_700_000_000.0
    spans = [_record("SpanRecord", rng, trace_id=str(rng.choice(corrs)), span_id=f"s{i}",
                     parent_span_id=[None, f"s{int(rng.integers(0, 8))}"][int(rng.integers(0, 2))],
                     start_s=t0 + float(rng.integers(0, 5000)) / 1000,
                     duration_ms=float(rng.integers(0, 3000)) / 3,
                     status=str(rng.choice(["ok", "ok", "error", "cancelled"])))
             for i in range(int(rng.integers(0, 8)))]
    attempts = [dict(attempt_no=i, correlation_id=corr, kind=str(rng.choice(["first", "failover"])),
                     placement=str(rng.choice(["", "svc@i0", "svc@i1"])),
                     started_at=t0 + i * 0.7, outcome=str(rng.choice(["ok", "superseded"])),
                     error_type=["", "dead:stale"][int(rng.integers(0, 2))],
                     tokens_delivered=int(rng.integers(0, 3)) * 4)
                for i, corr in enumerate(corrs)]
    record = _record("RunRecord", rng, run_id="ab" * 16, attempts=attempts,
                     started_at=t0, finished_at=t0 + float(rng.integers(0, 4)),
                     failovers=int(rng.integers(0, 3)), hedges=int(rng.integers(0, 2)))
    flight = {corr: [{"t_s": t0 + float(rng.integers(0, 4000)) / 1000, "event": "ADMIT"}]
              for corr in corrs if rng.integers(0, 2)}
    texts = {}
    for i, (name, (obs, _, _)) in enumerate(packages.items()):
        texts[name] = [
            _outcome(obs.render_waterfall, [s[i] for s in spans]),
            _outcome(obs.render_run_timeline, record[i], [s[i] for s in spans], flight),
            _outcome(obs.render_run_timeline, record[i], [], None),
        ]
    assert texts["port"] == texts["ref"]


@pytest.mark.parametrize("seed", SEEDS)
def test_flightrec_and_capacity_views_equal_the_reference(seed):
    """One request's flight-recorder timeline, the capacity dump's
    sparklines and its owner breakdown, from the same seeded events,
    samples and ledger."""
    from calfkit_tpu_torch.observability.flightrec import ARG_LABELS

    rng = np.random.default_rng(200 + seed)
    packages = _packages()
    names = sorted(ARG_LABELS) + ["UNKNOWN"]
    events = [dict(event=str(rng.choice(names)), t_s=float(rng.integers(0, 10**6)) / 1000,
                   slot=int(rng.integers(-1, 4)), a=int(rng.integers(0, 900)),
                   b=int(rng.integers(0, 900)), corr=str(rng.choice(["c1", "c2"])),
                   **({"note": "x=y"} if rng.integers(0, 4) == 0 else {}))
              for _ in range(int(rng.integers(0, 12)))]
    fields = ("pages_in_use", "pages_free", "prefix_resident_pages", "active_slots", "pending",
              "tokens_per_dispatch", "hbm_bytes_per_token")
    samples = [{f: float(rng.integers(0, 500)) / [1, 3][int(rng.integers(0, 2))] for f in fields}
               for _ in range(int(rng.integers(0, 90)))]
    meta = [None, {"label": "r0", "appended": 90, "dropped": 3}, {"label": "r1"}][seed % 3]
    breakdown = {
        "pages_in_use": int(rng.integers(0, 99)), "pages_total": 128,
        "private_pages": int(rng.integers(0, 50)), "shared_referenced_pages": 7,
        "prefix_resident_pages": 4, "headroom_pages": 11, "evicted_pages": 2, "alloc_stalls": 1,
        "by_owner": [{"corr": f"c{i}", "run": [None, "r"][i % 2], "lane": i % 3,
                      "pages": int(rng.integers(0, 30))} for i in range(int(rng.integers(0, 4)))],
        "by_owner_other_pages": int(rng.integers(0, 3)),
        "by_lane": {f"lane{i}": int(rng.integers(0, 9)) for i in range(int(rng.integers(0, 3)))},
        "by_chain": [{"chain": "f" * int(rng.integers(1, 20)), "refs": 2}],
        "by_chain_other_pages": int(rng.integers(0, 2)),
    }
    texts = {}
    for name, (obs, _, _) in packages.items():
        texts[name] = [
            _outcome(obs.render_timeline, events, "c1"),
            _outcome(obs.render_capacity_timeline, meta, samples),
            _outcome(obs.render_capacity_breakdown, breakdown),
            _outcome(obs.sparkline, [s["pages_free"] for s in samples], width=17),
        ]
    assert texts["port"] == texts["ref"]


@pytest.mark.parametrize("seed", SEEDS)
def test_sim_table_equals_the_reference(seed):
    """``ck sim``'s table over SIM.json with seeded verdicts flipped and
    metrics dropped, every option combination."""
    from calfkit_tpu.cli.sim import render_sim_table as ref_render
    from calfkit_tpu_torch.cli.sim import render_sim_table

    rng = np.random.default_rng(300 + seed)
    document = json.loads(open(_repo("SIM.json")).read())
    for scenario in document["scenarios"]:
        for check in scenario["checks"]:
            check["passed"] = bool(rng.integers(0, 4))
        scenario["passed"] = all(c["passed"] for c in scenario["checks"])
        if rng.integers(0, 3) == 0:
            scenario["metrics"].pop("prefix", None)
    document["passed"] = all(s["passed"] for s in document["scenarios"])
    if seed % 2:
        document.pop("capture")
    for kw in ({}, {"show_checks": True}, {"only": document["scenarios"][seed]["name"]},
               {"only": "nosuch"}):
        assert render_sim_table(document, **kw) == ref_render(document, **kw), kw


def test_dev_state_is_the_ports_own(monkeypatch, tmp_path):
    """The port's ``ck dev`` keeps its brokers and daemons under its own
    state directory (``$CALFKIT_DEV_DIR`` when set, as the reference's),
    spawns the port's brokers and starts its daemons as the port's ``ck``."""
    from calfkit_tpu.cli import _dev_state as ref
    from calfkit_tpu_torch.cli import _dev_state as port

    monkeypatch.delenv("CALFKIT_DEV_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert port.dev_dir() == tmp_path / ".calfkit_tpu_torch" / "dev"
    assert ref.dev_dir() == tmp_path / ".calfkit_tpu" / "dev"
    monkeypatch.setenv("CALFKIT_DEV_DIR", str(tmp_path / "mine"))
    assert port.dev_dir() == tmp_path / "mine"
    assert port.BROKER_KINDS == ref.BROKER_KINDS
    source = inspect.getsource(port)
    assert "calfkit_tpu_torch.mesh.kafka_wire import spawn_kafkad" in source
    assert "calfkit_tpu_torch.mesh.tcp import spawn_meshd" in source
    assert '"-m", "calfkit_tpu_torch.cli.main", "run"' in source
