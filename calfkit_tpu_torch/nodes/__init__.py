"""Node kinds over the shared kernel: the port's own copies of the JAX
package's agent, tool and consumer nodes."""

from calfkit_tpu_torch.nodes.agent import (
    Agent,
    BaseAgentNodeDef,
    StatelessAgent,
    render_fault_for_model,
    surface_to_model,
)

from calfkit_tpu_torch.nodes.base import BaseNodeDef, NodeRunContext, handler
from calfkit_tpu_torch.nodes.consumer import ConsumerContext, ConsumerNode, consumer
from calfkit_tpu_torch.nodes.fanout_store import (
    FANOUT_STORE_KEY,
    FanoutBatchStore,
    KtablesFanoutBatchStore,
)
from calfkit_tpu_torch.nodes.registry import RegistryMixin
from calfkit_tpu_torch.nodes.steps import (
    DeniedCall,
    HandedOff,
    HopStepLedger,
    InferenceFact,
    Observed,
    Said,
)
from calfkit_tpu_torch.nodes.tool import (
    ModelRetry,
    ToolNodeDef,
    Tools,
    agent_tool,
    eager_tools,
)

__all__ = [
    "surface_to_model",
    "render_fault_for_model",
    "Agent",
    "BaseAgentNodeDef",
    "BaseNodeDef",
    "ConsumerContext",
    "ConsumerNode",
    "DeniedCall",
    "FANOUT_STORE_KEY",
    "FanoutBatchStore",
    "HandedOff",
    "HopStepLedger",
    "InferenceFact",
    "KtablesFanoutBatchStore",
    "ModelRetry",
    "NodeRunContext",
    "Observed",
    "RegistryMixin",
    "Said",
    "StatelessAgent",
    "ToolNodeDef",
    "Tools",
    "agent_tool",
    "consumer",
    "eager_tools",
    "handler",
]
