"""Mesh transport: the Kafka-compatible substrate abstraction.

The port's own copy of ``calfkit_tpu.mesh``.  Three tiers ride one
interface:

1. pub/sub of envelopes + steps (:class:`MeshTransport.publish` /
   ``subscribe`` with key-ordered dispatch),
2. compacted tables for control-plane and fan-out state
   (:class:`TableReader` / :class:`TableWriter`),
3. topic admin (``ensure_topics``).

``InMemoryMesh`` is a full single-process implementation.  ``TcpMesh``
rides the in-repo ``meshd`` broker (the multi-process dev mesh).
``KafkaWireMesh`` — the dependency-free native wire-protocol client with
leader/coordinator routing, TLS and SASL — is the production adapter; it
pairs with the in-repo ``kafkad`` broker or any real Kafka/Redpanda
cluster.

The two wire transports load at first use (``from calfkit_tpu_torch.mesh
import KafkaWireMesh`` loads them): the wire client picks its CRC library
when it is first imported, so a caller that builds the native library
(:func:`calfkit_tpu_torch.mesh._native.build_native`) and points
``$CALFKIT_CRC32C`` at it may import this package first.
"""

from importlib import import_module
from typing import Any

from calfkit_tpu_torch.mesh.transport import MeshTransport, Record, Subscription
from calfkit_tpu_torch.mesh.dispatch import KeyOrderedDispatcher
from calfkit_tpu_torch.mesh.memory import InMemoryMesh
from calfkit_tpu_torch.mesh.tables import TableReader, TableWriter

_LAZY = {
    "ConnectionProfile": "calfkit_tpu_torch.mesh.connection",
    "KafkaWireMesh": "calfkit_tpu_torch.mesh.kafka_wire",
    "WireSecurity": "calfkit_tpu_torch.mesh.kafka_wire",
    "TcpMesh": "calfkit_tpu_torch.mesh.tcp",
}


def __getattr__(name: str) -> Any:
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)

__all__ = [
    "ConnectionProfile",
    "InMemoryMesh",
    "KafkaWireMesh",
    "KeyOrderedDispatcher",
    "MeshTransport",
    "Record",
    "Subscription",
    "TableReader",
    "TableWriter",
    "TcpMesh",
    "WireSecurity",
]
