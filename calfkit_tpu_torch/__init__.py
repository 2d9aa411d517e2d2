"""calfkit-tpu's agent mesh and local inference backend on PyTorch and CUDA.

A second package beside ``calfkit_tpu``: it imports ``torch`` and numpy,
never ``jax``, nothing of ``calfkit_tpu``, and no pydantic.  Its model
entry points run on a CUDA device unless the caller passes
``device="cpu"``; the attention kernels are hand-written CUDA C++
(``csrc/``) built at first use.

Public API (lazy — importing :mod:`calfkit_tpu_torch` pulls in nothing):

- ``Client`` / ``Worker`` — caller surface and serving host;
- ``Agent`` / ``StatelessAgent`` / ``agent_tool`` / ``consumer`` — node
  kinds (an ``Agent(output_type=...)`` answers with a typed result);
- ``MCPToolboxNode`` / ``Toolbox`` / ``Toolboxes`` / ``MCPServerSpec`` — an
  MCP server's tools as a mesh node, and their selectors;
- ``Tools`` / ``Messaging`` / ``Handoff`` — selectors and peers;
- ``FleetRouter`` / ``FailoverPolicy`` — replica placement and in-flight
  failover for ``Client(router=, failover=)``;
- ``InMemoryMesh`` / ``TcpMesh`` / ``KafkaWireMesh`` — the in-process mesh,
  the native ``meshd`` broker's and the Kafka wire protocol's transports;
- ``ProvisioningConfig`` — the worker's topic provisioning;
- ``TorchLocalModelClient`` — the local CUDA inference provider;
- ``OpenAIModelClient`` / ``OpenAIResponsesModelClient`` /
  ``AnthropicModelClient`` / ``GeminiModelClient`` / ``MistralModelClient`` /
  ``BedrockModelClient`` — remote model APIs, and ``FallbackModelClient``,
  which tries its models in order (the local card first, a remote API as
  the parachute).
"""

from __future__ import annotations

from importlib import import_module
from typing import TYPE_CHECKING, Any

__version__ = "0.1.0"

_LAZY: dict[str, str] = {
    # caller surface + serving host
    "Client": "calfkit_tpu_torch.client",
    "AgentGateway": "calfkit_tpu_torch.client",
    "InvocationHandle": "calfkit_tpu_torch.client",
    "InvocationResult": "calfkit_tpu_torch.client",
    "EventStream": "calfkit_tpu_torch.client",
    "RunCompleted": "calfkit_tpu_torch.client",
    "RunFailed": "calfkit_tpu_torch.client",
    "Mesh": "calfkit_tpu_torch.client",
    "Worker": "calfkit_tpu_torch.worker",
    # node kinds + selectors
    "Agent": "calfkit_tpu_torch.nodes",
    "StatelessAgent": "calfkit_tpu_torch.nodes",
    "BaseNodeDef": "calfkit_tpu_torch.nodes",
    "agent_tool": "calfkit_tpu_torch.nodes",
    "consumer": "calfkit_tpu_torch.nodes",
    "ConsumerNode": "calfkit_tpu_torch.nodes",
    "Tools": "calfkit_tpu_torch.nodes",
    "render_fault_for_model": "calfkit_tpu_torch.nodes",
    "surface_to_model": "calfkit_tpu_torch.nodes",
    "Toolbox": "calfkit_tpu_torch.mcp",
    "Toolboxes": "calfkit_tpu_torch.mcp",
    "MCPToolboxNode": "calfkit_tpu_torch.mcp",
    "MCPServerSpec": "calfkit_tpu_torch.mcp",
    "Messaging": "calfkit_tpu_torch.peers",
    "Handoff": "calfkit_tpu_torch.peers",
    # fleet routing (replicated engines) and in-flight failover
    "FleetRouter": "calfkit_tpu_torch.fleet",
    "FailoverPolicy": "calfkit_tpu_torch.fleet",
    "ReplicaRegistry": "calfkit_tpu_torch.fleet",
    # faults + exceptions
    "NodeFaultError": "calfkit_tpu_torch.exceptions",
    "ClientTimeoutError": "calfkit_tpu_torch.exceptions",
    "ClientClosedError": "calfkit_tpu_torch.exceptions",
    "DeserializationError": "calfkit_tpu_torch.exceptions",
    "MeshUnavailableError": "calfkit_tpu_torch.exceptions",
    "LifecycleConfigError": "calfkit_tpu_torch.exceptions",
    "FaultTypes": "calfkit_tpu_torch.models",
    "ErrorReport": "calfkit_tpu_torch.models",
    "ExceptionInfo": "calfkit_tpu_torch.models",
    # control plane + provisioning + tuning
    "ControlPlaneConfig": "calfkit_tpu_torch.controlplane",
    "ControlPlaneRecord": "calfkit_tpu_torch.controlplane",
    "ControlPlaneStamp": "calfkit_tpu_torch.controlplane",
    "ControlPlaneView": "calfkit_tpu_torch.controlplane",
    "ProvisioningConfig": "calfkit_tpu_torch.provisioning",
    "FanoutConfig": "calfkit_tpu_torch.tuning",
    # transports
    "InMemoryMesh": "calfkit_tpu_torch.mesh",
    "TcpMesh": "calfkit_tpu_torch.mesh",
    "KafkaWireMesh": "calfkit_tpu_torch.mesh",
    "ConnectionProfile": "calfkit_tpu_torch.mesh",
    "WireSecurity": "calfkit_tpu_torch.mesh",
    # observability: tracing + metrics (dependency-free)
    "TraceContext": "calfkit_tpu_torch.observability.trace",
    "Tracer": "calfkit_tpu_torch.observability.trace",
    "MetricsRegistry": "calfkit_tpu_torch.observability.metrics",
    "metrics_text": "calfkit_tpu_torch.observability.metrics",
    "MetricsServer": "calfkit_tpu_torch.observability.http",
    # model clients (the local CUDA path, deterministic test models and the
    # remote APIs over the port's own HTTP client)
    "TorchLocalModelClient": "calfkit_tpu_torch.inference",
    "EchoModelClient": "calfkit_tpu_torch.engine",
    "FunctionModelClient": "calfkit_tpu_torch.engine",
    "OpenAIModelClient": "calfkit_tpu_torch.providers",
    "OpenAIResponsesModelClient": "calfkit_tpu_torch.providers",
    "AnthropicModelClient": "calfkit_tpu_torch.providers",
    "GeminiModelClient": "calfkit_tpu_torch.providers",
    "MistralModelClient": "calfkit_tpu_torch.providers",
    "BedrockModelClient": "calfkit_tpu_torch.providers",
    "FallbackModelClient": "calfkit_tpu_torch.providers",
}

if TYPE_CHECKING:  # pragma: no cover
    from calfkit_tpu_torch.client import Client
    from calfkit_tpu_torch.exceptions import NodeFaultError
    from calfkit_tpu_torch.nodes import Agent, agent_tool
    from calfkit_tpu_torch.worker import Worker


def __getattr__(name: str) -> Any:
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_LAZY))
