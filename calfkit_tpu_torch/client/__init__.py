"""The caller surface (SURVEY.md §1 layer 8)."""

from calfkit_tpu_torch.client.caller import AgentGateway, Client
from calfkit_tpu_torch.client.events import EventStream
from calfkit_tpu_torch.client.hub import Hub, InvocationHandle, RunCompleted, RunFailed
from calfkit_tpu_torch.client.mesh import Mesh
from calfkit_tpu_torch.models.node_result import InvocationResult

__all__ = [
    "AgentGateway",
    "Client",
    "EventStream",
    "Hub",
    "InvocationHandle",
    "InvocationResult",
    "Mesh",
    "RunCompleted",
    "RunFailed",
]
