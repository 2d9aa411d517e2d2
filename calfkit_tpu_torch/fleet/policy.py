"""Routing policies: the explicit engine-selection seam.

A policy is a PURE function over an already-filtered candidate list:
eligibility (staleness, drain, readiness, exclusions) is the registry's
job, ranking is the policy's.  Keeping policies pure — no I/O, no
clocks, no broker reads — is what lets the fleet unit suite pin
their distribution properties in isolation and lets the hot routing
path stay allocation-light (the ``select`` bodies are ``@hotpath``).

Shipped policies:

- :class:`LeastLoaded` — global minimum queue depth.  Best placement
  per pick, but every concurrent router chasing the same minimum herds
  onto one replica between heartbeats.
- :class:`PowerOfTwoChoices` — sample two, take the less loaded
  (Mitzenmacher): near-optimal load spread with O(1) state reads and no
  herd, the fleet default.
- :class:`PrefixAffinity` — rendezvous-hash the request's page-aligned
  prompt prefix over the candidates so repeat agent sessions land on
  the replica whose ``PrefixCache`` already holds their shared-prefix
  pages; requests with no affinity key (short prompts) fall through to
  a load-aware fallback policy, and an ineligible home (draining,
  stale, shed-excluded) falls back to the key's stable next-ranked
  replica — not a fleet-wide reshuffle.

``rng`` knobs follow the :class:`~calfkit_tpu_torch.client.caller.RetryPolicy`
convention: a zero-arg callable returning a float in ``[0, 1)``, so the
chaos harness and the distribution tests inject determinism.
"""

from __future__ import annotations

from calfkit_tpu_torch.effects import hotpath

import random
from dataclasses import dataclass, field
from typing import Callable, Protocol, Sequence

from calfkit_tpu_torch.fleet.registry import Replica
from calfkit_tpu_torch.fleet.selection import page_aligned_prefix, stable_hash

__all__ = [
    "RouteRequest",
    "RoutingPolicy",
    "LeastLoaded",
    "PowerOfTwoChoices",
    "PrefixAffinity",
    "RandomChoice",
    "affinity_key_for",
    "resolve_policy",
    "POLICY_NAMES",
]

# default affinity quantum for UNtokenized prompts: ~page_size (16)
# tokens × ~4 chars/token.  Token-level alignment happens engine-side;
# the router only needs session turns to collapse to one key.
DEFAULT_AFFINITY_PAGE_CHARS = 64


@dataclass(frozen=True)
class RouteRequest:
    """What a policy may rank on for one placement decision."""

    agent: str
    affinity_key: "bytes | None" = None
    correlation_id: str = ""


class RoutingPolicy(Protocol):
    def select(
        self, candidates: Sequence[Replica], request: RouteRequest
    ) -> "Replica | None": ...


@hotpath
def _least(candidates: Sequence[Replica]) -> "Replica | None":
    # ties break FIRST on the advertised BATCH queue share, descending
    # (at equal total depth, a batch-heavy backlog is the
    # cheaper home — its queued work is exactly what priority shedding
    # evicts if an interactive arrival needs the slot, so interactive
    # latency there is bounded by sheds, not by the whole queue; with no
    # batch traffic anywhere, and on pre-QoS adverts, every replica
    # reports 0 and the tiebreak is exactly neutral — single-class
    # timelines are unchanged), THEN on the advert's EWMA dispatch
    # latency (between heartbeat beats N routers see identical
    # depths — breaking the tie on which replica actually dispatches
    # faster spreads the herd), THEN on the stable replica key, never on
    # list order: two routers looking at the same directory must still
    # agree.  A 0.0 EWMA means NO SIGNAL (pre-EWMA advert in a rolling
    # upgrade, or an engine that never dispatched) and ranks LAST among
    # ties — sorting it first would deterministically herd ALL tied
    # traffic onto the one replica nobody has latency evidence for, the
    # exact failure this tiebreak exists to kill.  All-unknown ties fall
    # through to the stable key, the pre-EWMA law.
    return min(
        candidates,
        key=lambda r: (
            r.queue_depth,
            -r.batch_depth,
            r.dispatch_ewma or float("inf"),
            r.key,
        ),
        default=None,
    )


@dataclass(frozen=True)
class LeastLoaded:
    """Global minimum queue depth (ties → lexicographic replica key)."""

    @hotpath
    def select(
        self, candidates: Sequence[Replica], request: RouteRequest
    ) -> "Replica | None":
        return _least(candidates)


@dataclass(frozen=True)
class RandomChoice:
    """Uniform random placement — the A/B baseline, not a recommendation."""

    rng: "Callable[[], float] | None" = None

    @hotpath
    def select(
        self, candidates: Sequence[Replica], request: RouteRequest
    ) -> "Replica | None":
        if not candidates:
            return None
        draw = (self.rng or random.random)()
        return candidates[min(int(draw * len(candidates)), len(candidates) - 1)]


@dataclass(frozen=True)
class PowerOfTwoChoices:
    """Two uniform samples, keep the less loaded (Mitzenmacher 2001)."""

    rng: "Callable[[], float] | None" = None

    @hotpath
    def select(
        self, candidates: Sequence[Replica], request: RouteRequest
    ) -> "Replica | None":
        n = len(candidates)
        if n <= 2:
            return _least(candidates)
        rng = self.rng or random.random
        i = min(int(rng() * n), n - 1)
        j = min(int(rng() * (n - 1)), n - 2)
        if j >= i:  # second draw over the remaining n-1: distinct by law
            j += 1
        return _least([candidates[i], candidates[j]])


@dataclass(frozen=True)
class PrefixAffinity:
    """Rendezvous-hashed session stickiness over shared-prefix pages.

    ``fallback`` ranks requests that carry no affinity key; it defaults
    to :class:`PowerOfTwoChoices` so a fleet configured for affinity
    degrades to load-aware (not random) placement on cold prompts."""

    fallback: RoutingPolicy = field(default_factory=PowerOfTwoChoices)

    @hotpath
    def select(
        self, candidates: Sequence[Replica], request: RouteRequest
    ) -> "Replica | None":
        if not candidates:
            return None
        affinity_key = request.affinity_key
        if affinity_key is None:
            return self.fallback.select(candidates, request)
        # the highest-random-weight pick — identical ordering law to
        # selection.rendezvous_rank, computed as an O(n) max instead of
        # a full sort (only the top rank is ever consumed: candidates
        # were pre-filtered for eligibility, so the max IS the best
        # still-eligible home, and a draining/stale/excluded home never
        # reaches this list — the key's next-ranked replica takes over
        # with no fleet-wide reshuffle)
        return max(
            candidates,
            key=lambda r: (
                stable_hash(affinity_key, salt=r.key.encode("utf-8")),
                r.key,
            ),
        )


@hotpath
def affinity_key_for(
    prompt: "Sequence[int] | str",
    *,
    page: "int | None" = None,
) -> "bytes | None":
    """The request's affinity key: hashable page-aligned prompt prefix
    (``None`` = no shared pages worth chasing; see selection module)."""
    if page is None:
        page = DEFAULT_AFFINITY_PAGE_CHARS if isinstance(prompt, str) else 16
    return page_aligned_prefix(prompt, page)


# names accepted wherever a policy can be configured (CLI, Client kwarg)
POLICY_NAMES = ("least-loaded", "p2c", "prefix-affinity", "random")


def resolve_policy(policy: "RoutingPolicy | str") -> RoutingPolicy:
    if not isinstance(policy, str):
        return policy
    table: dict[str, Callable[[], RoutingPolicy]] = {
        "least-loaded": LeastLoaded,
        "p2c": PowerOfTwoChoices,
        "power-of-two": PowerOfTwoChoices,
        "prefix-affinity": PrefixAffinity,
        "random": RandomChoice,
    }
    try:
        return table[policy]()
    except KeyError:
        raise ValueError(
            f"unknown routing policy {policy!r} (one of {POLICY_NAMES})"
        ) from None
