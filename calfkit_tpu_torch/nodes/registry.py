"""Handler registry: ``@handler(route)`` + per-subclass collection.

Reference: calfkit/_registry.py:64-194 (decorator + ``__init_subclass__``
collection + route-uniqueness enforcement).
"""

from __future__ import annotations

from typing import Any, Callable

from calfkit_tpu_torch.exceptions import RegistryConfigError
from calfkit_tpu_torch.routing import match_chain, validate_route_pattern

_HANDLER_ATTR = "__calfkit_route__"


def handler(route: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Mark a method as the body for deliveries whose route matches."""
    validate_route_pattern(route)

    def mark(fn: Callable[..., Any]) -> Callable[..., Any]:
        setattr(fn, _HANDLER_ATTR, route)
        return fn

    return mark


class RegistryMixin:
    """Collects ``@handler`` methods across the subclass MRO.

    A subclass redefining a route overrides its parent's handler for that
    route; two *different* methods on one class claiming the same route is a
    configuration error.
    """

    _route_handlers: dict[str, str]  # route pattern -> method name

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        routes: dict[str, str] = {}
        # walk MRO base-first so subclasses override parents
        for klass in reversed(cls.__mro__):
            own: dict[str, str] = {}
            for attr_name, attr in vars(klass).items():
                route = getattr(attr, _HANDLER_ATTR, None)
                if route is None:
                    continue
                if route in own and own[route] != attr_name:
                    raise RegistryConfigError(
                        f"{klass.__name__}: route {route!r} claimed by both "
                        f"{own[route]!r} and {attr_name!r}"
                    )
                own[route] = attr_name
            routes.update(own)
        cls._route_handlers = routes

    def handlers_for(self, route: str) -> list[Callable[..., Any]]:
        """Bound handler methods matching ``route``, most-specific first —
        the chain-of-responsibility order."""
        chain = match_chain(list(self._route_handlers), route)
        return [getattr(self, self._route_handlers[p]) for p in chain]
