"""MCP toolbox support: host an MCP server connection as a mesh node.

The port's own copy of ``calfkit_tpu.mcp``.  The MCP python SDK is not a
dependency — :mod:`calfkit_tpu_torch.mcp.transport` implements the minimal
JSON-RPC client (stdio + streamable HTTP) the toolbox needs: initialize,
tools/list, tools/call, and list_changed notifications.
"""

from calfkit_tpu_torch.mcp.toolbox import MCPToolboxNode, Toolbox, Toolboxes, mixed_tools
from calfkit_tpu_torch.mcp.transport import MCPError, MCPServerSpec, MCPSession

__all__ = ["MCPError", "MCPServerSpec", "MCPSession", "MCPToolboxNode", "Toolbox", "Toolboxes",
           "mixed_tools"]
