"""Worker lifecycle: two-phase hook brackets + ``@resource`` generators.

Reference: calfkit/worker/lifecycle.py:182-340.  Two bracket families:

- **resource phase** (outer): ``on_startup`` hooks and ``@resource`` async
  generators run before the broker serves; their teardown (``after_shutdown``
  + generator finalizers) runs last, after traffic has drained.
- **serving phase** (inner): ``after_startup`` runs once the broker is
  consuming (e.g. control-plane liveness announcements); ``on_shutdown``
  runs first at stop (e.g. tombstoning adverts while the broker still works).

A failed boot rolls back whatever started, in reverse order.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, AsyncIterator, Awaitable, Callable

from calfkit_tpu_torch.exceptions import LifecycleConfigError

logger = logging.getLogger(__name__)

Hook = Callable[[], Awaitable[None] | None]
ResourceFactory = Callable[[], AsyncIterator[Any]]


class LifecycleHookMixin:
    def __init__(self) -> None:
        self._on_startup: list[Hook] = []
        self._after_startup: list[Hook] = []
        self._on_shutdown: list[Hook] = []
        self._after_shutdown: list[Hook] = []
        self._resource_factories: list[tuple[str | None, ResourceFactory]] = []
        self._live_resources: list[tuple[str | None, AsyncIterator[Any]]] = []

    # ------------------------------------------------------------ decorators
    def on_startup(self, fn: Hook) -> Hook:
        self._on_startup.append(fn)
        return fn

    def after_startup(self, fn: Hook) -> Hook:
        self._after_startup.append(fn)
        return fn

    def on_shutdown(self, fn: Hook) -> Hook:
        self._on_shutdown.append(fn)
        return fn

    def after_shutdown(self, fn: Hook) -> Hook:
        self._after_shutdown.append(fn)
        return fn

    def resource(
        self, fn: ResourceFactory | None = None, *, key: str | None = None
    ) -> Any:
        """``@worker.resource`` on an async generator: code before ``yield``
        runs at boot, after it at teardown; a yielded value is stored under
        ``key`` (or the function name) in the worker's resource bag."""

        def register(f: ResourceFactory) -> ResourceFactory:
            if not inspect.isasyncgenfunction(f):
                raise LifecycleConfigError(
                    f"@resource requires an async generator function, got {f!r}"
                )
            self._resource_factories.append((key or f.__name__, f))
            return f

        return register(fn) if fn is not None else register

    # -------------------------------------------------------------- running
    async def _run_hooks(self, hooks: list[Hook], *, phase: str) -> None:
        for hook in hooks:
            result = hook()
            if inspect.isawaitable(result):
                await result

    async def _enter_resources(self, bag: dict[str, Any]) -> None:
        for key, factory in self._resource_factories:
            gen = factory()
            value = await gen.__anext__()
            self._live_resources.append((key, gen))
            if key is not None and value is not None:
                bag[key] = value

    async def _exit_resources(self) -> None:
        # swap-then-iterate (meshlint await-atomicity): detach before the
        # first await so enter/exit can never race a stale snapshot
        live, self._live_resources = self._live_resources, []
        for key, gen in reversed(live):
            try:
                await gen.__anext__()
            except StopAsyncIteration:
                pass
            except Exception:  # noqa: BLE001
                logger.exception("resource %r teardown failed", key)
            else:
                logger.warning("resource %r yielded more than once", key)
