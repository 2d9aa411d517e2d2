"""The Worker: hosts nodes on a shared mesh transport.

The port's own copy of ``calfkit_tpu.worker.worker``.  Responsibilities:

- register each node's key-ordered subscriber (input + return topics, one
  consumer group per node name → horizontal scaling via group membership);
- provision topics at boot;
- provide per-node durable fan-out stores;
- run the lifecycle brackets (see :mod:`calfkit_tpu_torch.worker.lifecycle`) with
  rollback on failed boot;
- wire the control plane (adverts + heartbeats + views) when available;
- three run surfaces: ``run()`` (blocking), ``start()/stop()``,
  ``async with``.

Workers are single-use objects (a stopped worker is not restartable),
matching the reference's stance (worker.py:628).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import signal
from typing import Any, Sequence

from calfkit_tpu_torch.exceptions import LifecycleConfigError
from calfkit_tpu_torch.mesh.transport import MeshTransport, Subscription
from calfkit_tpu_torch.nodes.base import BaseNodeDef
from calfkit_tpu_torch.nodes.fanout_store import FANOUT_STORE_KEY, KtablesFanoutBatchStore
from calfkit_tpu_torch.worker.lifecycle import LifecycleHookMixin

logger = logging.getLogger(__name__)


class Worker(LifecycleHookMixin):
    def __init__(
        self,
        nodes: Sequence[BaseNodeDef],
        *,
        mesh: "MeshTransport | str | None" = None,
        group_id: str | None = None,
        max_workers: int = 8,
        owns_transport: bool = False,
        control_plane: Any = None,
        fanout: Any = None,  # FanoutConfig | None
        provisioning: Any = None,  # ProvisioningConfig | None
        qos: Any = None,  # qos.TenantRateLimiter | None
    ):
        super().__init__()
        if not nodes:
            raise LifecycleConfigError("Worker requires at least one node")
        names = [n.name for n in nodes]
        if len(set(names)) != len(names):
            raise LifecycleConfigError(f"duplicate node names: {names}")
        self.nodes = list(nodes)
        from calfkit_tpu_torch.mesh.urls import resolve_mesh

        # mesh may be a transport, a url string, or None ($CALFKIT_MESH_URL);
        # a transport built HERE from a url is owned by the worker
        self.mesh, owned = resolve_mesh(mesh)
        self.group_id = group_id
        self.max_workers = max_workers
        self.owns_transport = owns_transport or owned
        from calfkit_tpu_torch.tuning import FanoutConfig

        if fanout is not None and not isinstance(fanout, FanoutConfig):
            raise LifecycleConfigError(
                f"fanout must be a FanoutConfig, got {type(fanout).__name__}"
            )
        self.fanout_config = fanout
        from calfkit_tpu_torch.provisioning import ProvisioningConfig

        if provisioning is not None and not isinstance(
            provisioning, ProvisioningConfig
        ):
            raise LifecycleConfigError(
                "provisioning must be a ProvisioningConfig, got "
                f"{type(provisioning).__name__}"
            )
        self.provisioning_config = provisioning
        # control plane default ON: pass False (or a disabled config) to opt
        # out; a ControlPlaneConfig customizes; a ControlPlane is used as-is
        from calfkit_tpu_torch.controlplane import ControlPlane, ControlPlaneConfig

        if control_plane is None or control_plane is True:
            control_plane = ControlPlane()
        elif control_plane is False:
            control_plane = None
        elif isinstance(control_plane, ControlPlaneConfig):
            control_plane = (
                ControlPlane(control_plane) if control_plane.enabled else None
            )
        elif not hasattr(control_plane, "attach"):
            raise LifecycleConfigError(
                f"control_plane must be a ControlPlane, ControlPlaneConfig, "
                f"True/False or None, got {type(control_plane).__name__}"
            )
        self.control_plane = control_plane
        # multi-tenant QoS: an opt-in per-tenant admission
        # token bucket shared by every node this worker hosts — the node
        # kernel's admission gate spends one token per ENTERING run and
        # refuses over-budget tenants with a typed, retriable
        # ``mesh.rate_limited`` fault before any queue or slot is held
        from calfkit_tpu_torch.qos import TenantRateLimiter

        if qos is not None and not isinstance(qos, TenantRateLimiter):
            raise LifecycleConfigError(
                f"qos must be a TenantRateLimiter, got {type(qos).__name__}"
            )
        self.qos = qos
        self.resources: dict[str, Any] = {}
        self._subscriptions: list[Subscription] = []
        self._stores: list[KtablesFanoutBatchStore] = []
        self._state = "new"  # new -> serving -> draining -> stopped
        self._advertiser: Any = None

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._state != "new":
            raise LifecycleConfigError(
                f"workers are single-use; this one is {self._state!r}"
            )
        try:
            await self._boot()
        except BaseException:
            logger.exception("worker boot failed; rolling back")
            await self._teardown(rollback=True)
            raise
        # atomicity-ok: workers are single-use single-owner (the guard
        # above raises on re-entry); nothing else writes _state during boot
        self._state = "serving"

    def ready(self) -> "tuple[bool, str]":
        """Readiness probe for ``MetricsServer.set_readiness``: True once
        boot finished — subscriptions registered, dispatch lanes running,
        control plane advertised.  Distinct from liveness: a worker mid-boot
        (or one that failed boot) is alive but must not receive traffic —
        and a DRAINING worker flips unready so load balancers route away
        while in-flight deliveries finish."""
        if self._state != "serving":
            return False, f"worker is {self._state}, not serving"
        return True, "serving"

    @property
    def draining(self) -> bool:
        """True once :meth:`drain` ran: the node kernel refuses NEW calls
        with a typed, retriable ``mesh.overloaded`` fault while in-flight
        deliveries (and owed returns/faults) complete normally."""
        return self._state == "draining"

    def drain(self) -> None:
        """Enter drain mode (SIGTERM does this automatically in
        :meth:`serve_forever`): ``/readyz`` flips false, new calls get
        typed ``OVERLOADED`` faults callers can retry elsewhere, in-flight
        work runs to completion.  Follow with :meth:`stop` — the
        dispatcher's graceful drain then finds empty lanes."""
        if self._state == "serving":
            self._state = "draining"
            logger.info("worker draining: new calls will be refused")

    async def _boot(self) -> None:
        await self._run_hooks(self._on_startup, phase="on_startup")
        await self._enter_resources(self.resources)
        await self.mesh.start()

        # provision every topic the nodes touch, through the classifying
        # provisioner (retry on transient broker trouble; an unauthorized
        # cluster fails loudly instead of looking flaky)
        from calfkit_tpu_torch.provisioning import ProvisioningConfig, provision

        await provision(self.mesh, self.nodes, self.provisioning_config)
        # downstream starters (fan-out store, control plane) skip their own
        # ensure_topics when the provisioner covered the framework tables —
        # AND when provisioning is disabled outright: enabled=False is the
        # operator saying "topics pre-exist; issue no admin round-trips at
        # all" (e.g. an ACL-restricted cluster), and a raw ensure here would
        # bypass the provisioner's unauthorized/retry classification
        prov = self.provisioning_config or ProvisioningConfig()
        ensure_framework = prov.enabled and not prov.include_framework

        for node in self.nodes:
            node.bind(self.mesh)
            node.resources.setdefault("worker", self)
            if self.qos is not None:
                from calfkit_tpu_torch.nodes.base import QOS_LIMITER_KEY

                node.resources.setdefault(QOS_LIMITER_KEY, self.qos)
            for key, value in self.resources.items():
                node.resources.setdefault(key, value)
            if FANOUT_STORE_KEY not in node.resources:
                store = KtablesFanoutBatchStore(
                    self.mesh, node.node_id, self.fanout_config
                )
                await store.start(ensure=ensure_framework)
                self._stores.append(store)
                node.resources[FANOUT_STORE_KEY] = store

        # session-backed nodes (MCP toolboxes) connect before adverts so
        # their capability records list real tools; independent handshakes
        # run in parallel
        sessions = [n for n in self.nodes if hasattr(n, "start_session")]
        if sessions:
            await asyncio.gather(*(n.start_session() for n in sessions))

        # control plane attaches BEFORE subscriptions: a delivery consumed
        # in the boot window must already find its views
        if self.control_plane is not None:
            self._advertiser = await self.control_plane.attach(
                self, ensure=ensure_framework
            )

        for node in self.nodes:
            subscribe_topics = list(node.input_topics()) + [node.return_topic()]
            subscription = await self.mesh.subscribe(
                subscribe_topics,
                node.handler,
                group_id=self.group_id or node.name,
                max_workers=self.max_workers,
            )
            self._subscriptions.append(subscription)

        await self._run_hooks(self._after_startup, phase="after_startup")

    async def stop(self) -> None:
        if self._state == "stopped":
            return
        self._state = "stopped"
        await self._teardown(rollback=False)

    async def _teardown(self, *, rollback: bool) -> None:
        with contextlib.suppress(Exception):
            await self._run_hooks(self._on_shutdown, phase="on_shutdown")
        if self._advertiser is not None:
            with contextlib.suppress(Exception):
                await self._advertiser.stop()  # tombstones before drain
            self._advertiser = None
        # swap-then-iterate (meshlint await-atomicity): detach before
        # the first await so a subscription registered mid-teardown can
        # never be dropped from a snapshot already walked
        subscriptions, self._subscriptions = self._subscriptions, []
        for subscription in subscriptions:
            with contextlib.suppress(Exception):
                await subscription.stop()
        stores, self._stores = self._stores, []
        for store in stores:
            with contextlib.suppress(Exception):
                await store.stop()
        for node in self.nodes:
            if hasattr(node, "stop_session"):
                with contextlib.suppress(Exception):
                    await node.stop_session()
        with contextlib.suppress(Exception):
            await self._run_hooks(self._after_shutdown, phase="after_shutdown")
        await self._exit_resources()
        if self.owns_transport:
            with contextlib.suppress(Exception):
                await self.mesh.stop()
        if rollback:
            self._state = "stopped"

    # --------------------------------------------------------- run surfaces
    async def __aenter__(self) -> "Worker":
        await self.start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.stop()

    async def serve_forever(self) -> None:
        """Start and serve until cancelled (SIGINT/SIGTERM aware).

        SIGTERM is the orchestrator's polite eviction: it triggers drain
        mode FIRST (readiness flips, new calls fault ``OVERLOADED``) and
        then the normal stop, whose dispatcher drain lets in-flight
        deliveries finish.  SIGINT stops without the drain gate (the
        operator at the keyboard wants out now)."""
        await self.start()
        stop_event = asyncio.Event()
        loop = asyncio.get_running_loop()

        def terminate() -> None:
            self.drain()
            stop_event.set()

        with contextlib.suppress(NotImplementedError, RuntimeError):
            loop.add_signal_handler(signal.SIGINT, stop_event.set)
        with contextlib.suppress(NotImplementedError, RuntimeError):
            loop.add_signal_handler(signal.SIGTERM, terminate)
        try:
            await stop_event.wait()
        finally:
            await self.stop()

    def run(self) -> None:
        """Blocking entrypoint: boot, serve until SIGINT/SIGTERM, drain."""
        asyncio.run(self.serve_forever())
