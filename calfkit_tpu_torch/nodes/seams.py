"""Policy-seam chain runner.

The four seams (reference: calfkit/nodes/_seams.py:23-136 and the seam table
in nodes/base.py):

- ``before_node(ctx)`` — guard/mutate before the body; a non-``None``
  return SHORT-CIRCUITS the body and is published as the hop's action
  (plain strings/dicts are coerced to a reply — see base._as_action).
- ``after_node(ctx, action)`` — transform the body's action; a
  non-``None`` return replaces it (same coercion).
- ``on_node_error(ctx, report)`` — recover the node's own raise; returns a
  substitute action, or ``None`` to pass down the chain (fault escalates if
  no seam recovers).
- ``on_callee_error(ctx, report)`` — recover a downstream fault; returns
  substitute content parts, or ``None`` to escalate.

Chains run in registration order; the first non-``None`` return wins.  A seam
raising :class:`NodeFaultError` *mints* a typed fault (it is not treated as a
seam crash); any other raise is itself a node error.
"""

from __future__ import annotations

import inspect
from typing import Any, Awaitable, Callable, Sequence

from calfkit_tpu_torch.exceptions import NodeFaultError, SeamContractError

Seam = Callable[..., Any]


def validate_seam_arity(seam: Seam, expected: int, *, name: str) -> None:
    try:
        sig = inspect.signature(seam)
    except (TypeError, ValueError):
        return  # builtins / partials without introspection: trust the caller
    positional = [
        p
        for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        and p.default is p.empty
    ]
    has_var = any(p.kind == p.VAR_POSITIONAL for p in sig.parameters.values())
    if not has_var and len(positional) != expected:
        raise SeamContractError(
            f"{name} seam {getattr(seam, '__name__', seam)!r} must take "
            f"{expected} positional argument(s), found {len(positional)}"
        )


async def _call(seam: Seam, *args: Any) -> Any:
    result = seam(*args)
    if inspect.isawaitable(result):
        result = await result
    return result


async def run_chain(seams: Sequence[Seam], *args: Any) -> Any:
    """First non-None result wins; ``None`` falls through the chain."""
    for seam in seams:
        result = await _call(seam, *args)
        if result is not None:
            return result
    return None


class MintedFault(Exception):
    """Internal: a seam raised NodeFaultError — carry it out of the chain
    without confusing it with a seam crash (reference: the ``_Minted``
    sentinel, _seams.py:53)."""

    def __init__(self, error: NodeFaultError):
        self.error = error
        super().__init__(str(error))


async def run_chain_guarded(seams: Sequence[Seam], *args: Any) -> Any:
    """Like :func:`run_chain` but distinguishes a deliberate typed-fault mint
    (NodeFaultError) from an accidental seam crash."""
    for seam in seams:
        try:
            result = await _call(seam, *args)
        except NodeFaultError as exc:
            raise MintedFault(exc) from exc
        if result is not None:
            return result
    return None
