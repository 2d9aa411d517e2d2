"""Mesh URL resolution — one grammar for the Client and the Worker.

The port's own copy of ``calfkit_tpu.mesh.urls``.  Only ``memory://``
resolves: the TCP and Kafka transports are not ported yet, and their URLs
raise :class:`~calfkit_tpu_torch.exceptions.MeshUnavailableError` naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import os

from calfkit_tpu_torch.exceptions import MeshUnavailableError
from calfkit_tpu_torch.mesh.transport import MeshTransport

MESH_URL_ENV = "CALFKIT_MESH_URL"


def mesh_from_url(url: str) -> MeshTransport:
    """``memory://``; ``tcp://host:port`` and ``kafka://host:port[,...]``
    (``kafka+wire://``) are refused with a typed
    :class:`MeshUnavailableError` until their transports are ported."""
    if url.startswith("memory://"):
        from calfkit_tpu_torch.mesh.memory import InMemoryMesh

        return InMemoryMesh()
    if url.startswith(("tcp://", "kafka+wire://", "kafka://")):
        scheme = url.split("://", 1)[0]
        raise MeshUnavailableError(
            f"mesh url {url!r}: the {scheme}:// transport is not ported to "
            "calfkit_tpu_torch yet (ROADMAP Queue 1, the TCP and Kafka "
            "transports); use an InMemoryMesh",
            reason="not_ported",
        )
    raise ValueError(
        f"unsupported mesh url {url!r} "
        "(use memory://, tcp://host:port, or kafka://host:port)"
    )


def resolve_mesh(
    mesh: "MeshTransport | str | None",
    *,
    allow_memory: bool = True,
    default: str | None = None,
) -> tuple[MeshTransport, bool]:
    """Accept a transport, a URL string, or None (→ $CALFKIT_MESH_URL,
    then ``default`` when given).

    → (transport, owned): ``owned`` is True when THIS call constructed the
    transport from a url — the caller is then responsible for stopping it.

    ``allow_memory=False`` rejects ``memory://`` urls: a fresh in-process
    mesh resolved from a URL can by construction reach no worker, so a
    client connecting that way would only ever time out (the CLI allows it
    because the CLI also hosts the worker in the same process).
    """
    if isinstance(mesh, MeshTransport):
        return mesh, False
    if isinstance(mesh, str):
        url = mesh
    elif mesh is None:
        url = os.environ.get(MESH_URL_ENV) or default or ""
        if not url:
            raise ValueError(
                "no mesh given and CALFKIT_MESH_URL is unset — pass a "
                "transport, a url (tcp://host:port, kafka://host:port), "
                "or export CALFKIT_MESH_URL"
            )
    else:
        raise TypeError(
            f"mesh must be a MeshTransport, url string, or None, got "
            f"{type(mesh).__name__}"
        )
    if not allow_memory and url.startswith("memory://"):
        raise ValueError(
            "memory:// resolved from a url is a brand-new isolated mesh — "
            "no worker can share it; pass the worker's InMemoryMesh object "
            "instead (or use tcp://, kafka://)"
        )
    return mesh_from_url(url), True
