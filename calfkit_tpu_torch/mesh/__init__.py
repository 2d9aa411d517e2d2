"""Mesh transport: the Kafka-compatible substrate abstraction.

The port's own copy of ``calfkit_tpu.mesh``'s in-process tier.  Three
tiers ride one interface:

1. pub/sub of envelopes + steps (:class:`MeshTransport.publish` /
   ``subscribe`` with key-ordered dispatch),
2. compacted tables for control-plane and fan-out state
   (:class:`TableReader` / :class:`TableWriter`),
3. topic admin (``ensure_topics``).

``InMemoryMesh`` is a full single-process implementation.  The TCP and
Kafka transports are not ported yet (ROADMAP Queue 1): their URLs raise
:class:`~calfkit_tpu_torch.exceptions.MeshUnavailableError`.
"""

from calfkit_tpu_torch.mesh.transport import MeshTransport, Record, Subscription
from calfkit_tpu_torch.mesh.dispatch import KeyOrderedDispatcher
from calfkit_tpu_torch.mesh.memory import InMemoryMesh
from calfkit_tpu_torch.mesh.tables import TableReader, TableWriter

__all__ = [
    "InMemoryMesh",
    "KeyOrderedDispatcher",
    "MeshTransport",
    "Record",
    "Subscription",
    "TableReader",
    "TableWriter",
]
