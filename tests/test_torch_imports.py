"""The import law of the PyTorch port: ``calfkit_tpu_torch`` and
``chip_smoke.py`` import neither ``jax`` nor anything of ``calfkit_tpu``,
nor ``pydantic``, ``pydantic_core``, ``httpx``, ``click``, ``safetensors``,
``ml_dtypes`` or ``transformers`` (the card's machine has none of them):
the one exception is ``HFTokenizer``'s lazy import of ``transformers``
when one is built.  Every module of the port, the agent mesh's, its wire
transports', the type adapter's, the MCP client's (on the port's own HTTP
client), the metrics endpoint's, the scenario runner's, the ``ck``
command's and the remote model providers' included, imports with those
packages blocked, a typed adapter validates with them blocked, a remote
provider behind ``FallbackModelClient`` answers over the port's
``MockTransport`` with them blocked, and ``python -m calfkit_tpu_torch.cli`` answers
``--help`` with them blocked.  The engine and the model client refuse to
fall back to the CPU when no card is present."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "calfkit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "calfkit_tpu", "pydantic", "pydantic_core", "httpx", "click",
          "safetensors", "ml_dtypes", "transformers")
# (file, enclosing function, package): the lazy imports the law allows
LAZY_ALLOWED = {
    ("calfkit_tpu_torch/inference/tokenizer.py", "HFTokenizer.__init__", "transformers"),
}

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

BLOCKED = ("jax", "calfkit_tpu", "pydantic", "pydantic_core", "httpx", "click",
           "safetensors", "transformers", "ml_dtypes")
sys.meta_path.insert(0, Block())
for name in BLOCKED:
    sys.modules[name] = None
import calfkit_tpu_torch
names = [m.name for m in pkgutil.walk_packages(calfkit_tpu_torch.__path__, "calfkit_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("calfkit_tpu_torch.inference.client", "calfkit_tpu_torch.inference.tokenizer",
             "calfkit_tpu_torch.engine.model_client", "calfkit_tpu_torch.models.messages",
             "calfkit_tpu_torch.models.payload", "calfkit_tpu_torch.models.capability",
             "calfkit_tpu_torch.inference.quant", "calfkit_tpu_torch.inference.loader",
             "calfkit_tpu_torch.inference.graphs",
             "calfkit_tpu_torch.inference._safetensors", "calfkit_tpu_torch.cancellation",
             "calfkit_tpu_torch.leases", "calfkit_tpu_torch.qos",
             "calfkit_tpu_torch.observability.metrics", "calfkit_tpu_torch.observability.flightrec",
             "calfkit_tpu_torch.observability.capacity", "calfkit_tpu_torch.observability.trace",
             # the agent mesh
             "calfkit_tpu_torch.protocol", "calfkit_tpu_torch.keying", "calfkit_tpu_torch.routing",
             "calfkit_tpu_torch.tuning", "calfkit_tpu_torch.effects", "calfkit_tpu_torch.utils_names",
             "calfkit_tpu_torch.exceptions", "calfkit_tpu_torch.models._wire",
             "calfkit_tpu_torch.models.session_context", "calfkit_tpu_torch.models.state",
             "calfkit_tpu_torch.models.actions", "calfkit_tpu_torch.models.reply",
             "calfkit_tpu_torch.models.error_report", "calfkit_tpu_torch.models.marker",
             "calfkit_tpu_torch.models.tool_dispatch", "calfkit_tpu_torch.models.step",
             "calfkit_tpu_torch.models.node_result", "calfkit_tpu_torch.models.agents",
             "calfkit_tpu_torch.models.fanout", "calfkit_tpu_torch.models.records",
             "calfkit_tpu_torch.mesh", "calfkit_tpu_torch.mesh.tables",
             "calfkit_tpu_torch.mesh.transport", "calfkit_tpu_torch.mesh.dispatch",
             "calfkit_tpu_torch.mesh.memory", "calfkit_tpu_torch.mesh.urls",
             # the wire transports and the provisioner
             "calfkit_tpu_torch.mesh._native", "calfkit_tpu_torch.mesh.connection",
             "calfkit_tpu_torch.mesh.tcp", "calfkit_tpu_torch.mesh.kafka_wire",
             "calfkit_tpu_torch.provisioning", "calfkit_tpu_torch.provisioning.provisioner",
             "calfkit_tpu_torch.fleet", "calfkit_tpu_torch.fleet.selection",
             # the serving fleet and its chaos harness
             "calfkit_tpu_torch.fleet.registry", "calfkit_tpu_torch.fleet.policy",
             "calfkit_tpu_torch.fleet.router", "calfkit_tpu_torch.fleet.failover",
             "calfkit_tpu_torch.sim", "calfkit_tpu_torch.sim.clock",
             "calfkit_tpu_torch.sim.scenario", "calfkit_tpu_torch.sim.stubs",
             "calfkit_tpu_torch.sim.transport", "calfkit_tpu_torch.sim.topology",
             "calfkit_tpu_torch.sim.chaos",
             # the scenario runner and the ck command
             "calfkit_tpu_torch.sim.ids", "calfkit_tpu_torch.sim.report",
             "calfkit_tpu_torch.sim.runner", "calfkit_tpu_torch.sim.suite",
             "calfkit_tpu_torch.cli", "calfkit_tpu_torch.cli.__main__",
             "calfkit_tpu_torch.cli._common", "calfkit_tpu_torch.cli.main",
             "calfkit_tpu_torch.cli.obs", "calfkit_tpu_torch.cli.sim",
             "calfkit_tpu_torch.cli.chat", "calfkit_tpu_torch.cli.run",
             "calfkit_tpu_torch.cli.topics", "calfkit_tpu_torch.cli.dev",
             "calfkit_tpu_torch.cli._dev_state", "calfkit_tpu_torch.cli._reload",
             "calfkit_tpu_torch.engine.schema", "calfkit_tpu_torch.engine.turn",
             "calfkit_tpu_torch.engine.testing", "calfkit_tpu_torch.nodes",
             "calfkit_tpu_torch.nodes.registry", "calfkit_tpu_torch.nodes.seams",
             "calfkit_tpu_torch.nodes.steps", "calfkit_tpu_torch.nodes.fanout_store",
             "calfkit_tpu_torch.nodes.base", "calfkit_tpu_torch.nodes.projection",
             "calfkit_tpu_torch.nodes.tool", "calfkit_tpu_torch.nodes.agent",
             "calfkit_tpu_torch.peers", "calfkit_tpu_torch.peers.directory",
             "calfkit_tpu_torch.peers.handoff", "calfkit_tpu_torch.peers.messaging",
             "calfkit_tpu_torch.controlplane", "calfkit_tpu_torch.controlplane.config",
             "calfkit_tpu_torch.controlplane.publisher", "calfkit_tpu_torch.controlplane.view",
             "calfkit_tpu_torch.controlplane.plane", "calfkit_tpu_torch.worker",
             "calfkit_tpu_torch.worker.lifecycle", "calfkit_tpu_torch.worker.worker",
             "calfkit_tpu_torch.client", "calfkit_tpu_torch.client.events",
             "calfkit_tpu_torch.client.hub", "calfkit_tpu_torch.client.caller",
             "calfkit_tpu_torch.client.mesh", "calfkit_tpu_torch.observability.runledger",
             # typed agents and the mesh's other node kinds
             "calfkit_tpu_torch.models._adapter", "calfkit_tpu_torch._http",
             "calfkit_tpu_torch.mcp", "calfkit_tpu_torch.mcp.transport",
             "calfkit_tpu_torch.mcp.toolbox", "calfkit_tpu_torch.nodes.consumer",
             "calfkit_tpu_torch.observability.http",
             # the remote model providers
             "calfkit_tpu_torch.providers", "calfkit_tpu_torch.providers.http",
             "calfkit_tpu_torch.providers.openai", "calfkit_tpu_torch.providers.mistral",
             "calfkit_tpu_torch.providers.openai_responses",
             "calfkit_tpu_torch.providers.anthropic", "calfkit_tpu_torch.providers.gemini",
             "calfkit_tpu_torch.providers.bedrock", "calfkit_tpu_torch.providers.fallback"):
    assert name in names, name
from calfkit_tpu_torch import Agent, Client, Worker, agent_tool
from calfkit_tpu_torch import MCPToolboxNode, MetricsServer, Toolbox, consumer
import dataclasses, enum
from calfkit_tpu_torch.models._adapter import Adapter

class Kind(enum.Enum):
    A = "a"

@dataclasses.dataclass
class Leg:
    kind: Kind
    km: "int | None" = None

adapter = Adapter(tuple[Leg, ...])
assert adapter.json_schema()["$defs"]["Leg"]["required"] == ["kind"]
assert adapter.validate_python([{"kind": "a", "km": "3"}]) == (Leg(Kind.A, 3),)
assert adapter.dump((Leg(Kind.A),)) == [{"kind": "a", "km": None}]
from calfkit_tpu_torch.mesh import InMemoryMesh, KafkaWireMesh, TcpMesh
from calfkit_tpu_torch.provisioning import ProvisioningConfig, provision
from calfkit_tpu_torch.inference import TorchLocalModelClient
import asyncio
from calfkit_tpu_torch import FallbackModelClient, OpenAIModelClient
from calfkit_tpu_torch._http import HTTPClient, MockTransport, Response
from calfkit_tpu_torch.models import user_message
from calfkit_tpu_torch.providers import ModelAPIError

def answer(request):
    if "down" in request.url:
        return Response(503, text="overloaded")
    return Response(200, json={"choices": [{"message": {"content": "ok"}}]})

http = HTTPClient(transport=MockTransport(answer))
client = FallbackModelClient(
    OpenAIModelClient("m", api_key="k", base_url="https://down.example/v1", http_client=http),
    OpenAIModelClient("m", api_key="k", http_client=http))
assert asyncio.run(client.request([user_message("hi")])).text() == "ok"
import chip_smoke
assert not any(m.split(".")[0] in BLOCKED for m, v in sys.modules.items() if v is not None)
print("OK")
"""


def test_port_imports_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


_CK_HELP = """
import runpy, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

BLOCKED = ("jax", "calfkit_tpu", "pydantic", "pydantic_core", "httpx", "click")
sys.meta_path.insert(0, Block())
for name in BLOCKED:
    sys.modules[name] = None
sys.argv = ["ck", *ARGS]
runpy.run_module("calfkit_tpu_torch.cli", run_name="__main__")
"""


@pytest.mark.parametrize("args", [["--help"], ["sim", "--help"]], ids=" ".join)
def test_ck_answers_help_with_click_and_the_reference_blocked(args):
    """``python -m calfkit_tpu_torch.cli`` with ``click``, ``httpx``, ``jax``,
    pydantic and the JAX package blocked: ``--help`` exits 0 and lists
    the subcommands (or the subcommand's options)."""
    proc = subprocess.run(
        [sys.executable, "-c", _CK_HELP.replace("ARGS", repr(args))], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    words = ("--path", "--checks", "--scenario") if args[0] == "sim" else (
        "run", "dev", "chat", "topics", "trace", "stats", "fleet", "leases", "timeline",
        "slo", "capacity", "sim")
    assert all(word in proc.stdout for word in words), proc.stdout


_DISPATCH_ONLY = """
import sys
import calfkit_tpu_torch.mesh.dispatch
from calfkit_tpu_torch.fleet import selection
assert selection.lane_of(b"k", 4) == selection.lane_of(b"k", 4)
loaded = sorted(m for m in sys.modules if m.startswith("calfkit_tpu_torch.fleet."))
print(loaded)
"""


def test_the_dispatcher_pulls_in_only_the_fleet_selection():
    """``mesh/dispatch`` imports ``fleet.selection`` for its lane law; the
    fleet package's lazy ``__init__`` keeps the router, registry, policies
    and failover (and the control-plane models they read) out of it."""
    proc = subprocess.run(
        [sys.executable, "-c", _DISPATCH_ONLY], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "['calfkit_tpu_torch.fleet.selection']"


def _imports(tree: ast.AST) -> "list[tuple[str, str]]":
    """(module imported, the qualified name of the enclosing function or
    class; "" at module scope) for every import in ``tree``."""
    found = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                visit(child, f"{scope}.{child.name}" if scope else child.name)
                continue
            if isinstance(child, ast.Import):
                found.extend((alias.name, scope) for alias in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module:
                found.append((child.module, scope))
            visit(child, scope)

    visit(tree, "")
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    where = str(path.relative_to(ROOT))
    bad = [
        (name, scope) for name, scope in _imports(tree)
        if name.split(".")[0] in BANNED
        and (where, scope, name.split(".")[0]) not in LAZY_ALLOWED
    ]
    assert not bad, f"{path.name} imports {bad}"


def test_the_scan_covers_every_module_of_the_port():
    """The AST scan's files are every module of the package, the remote
    providers' among them, and ``chip_smoke.py``."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    providers = {f"calfkit_tpu_torch/providers/{name}.py" for name in (
        "__init__", "http", "openai", "mistral", "openai_responses", "anthropic", "gemini",
        "bedrock", "fallback")}
    assert providers <= scanned and "calfkit_tpu_torch/_http.py" in scanned
    assert "chip_smoke.py" in scanned


def test_transformers_is_imported_only_inside_hf_tokenizer():
    path = ROOT / "calfkit_tpu_torch" / "inference" / "tokenizer.py"
    found = [(name, scope) for name, scope in _imports(ast.parse(path.read_text()))
             if name.split(".")[0] == "transformers"]
    assert found == [("transformers", "HFTokenizer.__init__")]


def test_engine_without_a_card_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from calfkit_tpu_torch.exceptions import InferenceError
    from calfkit_tpu_torch.inference.config import RuntimeConfig, preset
    from calfkit_tpu_torch.inference.engine import InferenceEngine

    with pytest.raises(InferenceError, match="no CUDA device"):
        InferenceEngine(preset("debug"), RuntimeConfig(max_batch_size=2, max_seq_len=64))


def test_client_without_a_card_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import asyncio

    from calfkit_tpu_torch.exceptions import InferenceError
    from calfkit_tpu_torch.inference import TorchLocalModelClient
    from calfkit_tpu_torch.inference.config import RuntimeConfig

    client = TorchLocalModelClient(
        config="debug", runtime=RuntimeConfig(max_batch_size=2, max_seq_len=64)
    )
    with pytest.raises(InferenceError, match="no CUDA device"):
        asyncio.run(client.start())


_WORKER_SCRIPT = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

BLOCKED = ("jax", "jaxlib", "calfkit_tpu", "pydantic", "pydantic_core", "httpx", "click",
           "safetensors", "transformers", "ml_dtypes")
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)


def banned(engine):
    return sorted(m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in BLOCKED)


if __name__ == "__main__":
    import asyncio
    from calfkit_tpu_torch.inference.config import RuntimeConfig, preset
    from calfkit_tpu_torch.inference.engine import InferenceEngine

    engine = InferenceEngine(preset("debug"), RuntimeConfig(
        max_batch_size=2, max_seq_len=64, prefill_chunk=16, tp=2), device="cpu")
    found = engine.on_ranks(banned)
    asyncio.run(engine.stop())
    assert found == [[], []], found
    print("OK")
"""


def test_spawned_worker_imports_no_banned_package(tmp_path):
    """A tp = 2 engine's spawned worker process (rank 1) runs with the
    banned packages blocked and has none of them loaded."""
    script = tmp_path / "worker_law.py"
    script.write_text(_WORKER_SCRIPT.replace("ROOT", repr(str(ROOT))))
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")
