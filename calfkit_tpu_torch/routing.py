"""Route grammar: ``.``-delimited patterns with optional trailing ``*``.

A *route* is the logical address inside a node's handler table (distinct from
the Kafka topic, which addresses the node itself).  Routes are dot-delimited
identifier segments; a handler may register a *pattern* whose final segment is
``*``, matching any suffix.  More-specific patterns win.

Reference: calfkit/_routing.py:14-80 (same grammar and specificity ordering).
"""

from __future__ import annotations

import re

_SEGMENT = re.compile(r"^[a-zA-Z0-9_-]+$")


class RouteError(ValueError):
    pass


def validate_route(route: str) -> str:
    """Validate a concrete (wildcard-free) route."""
    if not route:
        raise RouteError("route must be non-empty")
    for seg in route.split("."):
        if not _SEGMENT.match(seg):
            raise RouteError(f"invalid route segment {seg!r} in {route!r}")
    return route


def validate_route_pattern(pattern: str) -> str:
    """Validate a handler pattern: a route whose final segment may be ``*``."""
    if not pattern:
        raise RouteError("route pattern must be non-empty")
    segments = pattern.split(".")
    for i, seg in enumerate(segments):
        if seg == "*":
            if i != len(segments) - 1:
                raise RouteError(
                    f"wildcard only allowed as the final segment: {pattern!r}"
                )
        elif not _SEGMENT.match(seg):
            raise RouteError(f"invalid segment {seg!r} in pattern {pattern!r}")
    return pattern


def route_matches(pattern: str, route: str) -> bool:
    """Does ``pattern`` match the concrete ``route``?

    ``a.b`` matches only ``a.b``; ``a.*`` matches ``a``, ``a.b``, ``a.b.c``;
    a bare ``*`` matches everything.
    """
    if pattern == route:
        return True
    if pattern == "*":
        return True
    if pattern.endswith(".*"):
        prefix = pattern[:-2]
        return route == prefix or route.startswith(prefix + ".")
    return False


def specificity(pattern: str) -> tuple[int, int]:
    """Sort key: exact patterns before wildcards, longer prefixes first."""
    if pattern == "*":
        return (1, 0)
    if pattern.endswith(".*"):
        return (1, -len(pattern.split(".")))
    return (0, -len(pattern.split(".")))


def match_chain(patterns: list[str], route: str) -> list[str]:
    """All patterns matching ``route``, most-specific first.

    This is the chain-of-responsibility order for routed dispatch
    (reference: calfkit/_routing.py:72).
    """
    return sorted((p for p in patterns if route_matches(p, route)), key=specificity)
