"""In-flight failure recovery: the pure laws (see docs/robustness.md,
"Failure recovery").

The fleet router routes NEW calls around dead replicas; this
module is about the call that was already PLACED when its replica died —
process kill, OOM, a wedged device grant.  Three small, pure pieces the
gateway's failover supervisor (``client/caller.py``) composes:

- :class:`FailoverPolicy` — the caller's knobs: how often to probe an
  outstanding placement's health, how many re-placements one call may
  burn, and (optionally) the ``hedge_after`` latency past which a
  duplicate dispatch races the original.
- :func:`placement_verdict` — THE dead-placement law, shared by the
  gateway supervisor and the ``ck fleet`` table (one copy, or the
  operator tool drifts from what failover actually does).  A placement
  is dead when its replica's advert is *gone* from the directory,
  *stale* past ``stale_after`` (on the ``cancellation.wall_clock``
  seam), or flipped *unready without draining* (boot loss, wedge
  watchdog).  Draining is NOT dead: a draining replica finishes its
  in-flight work by contract.
- :class:`StreamLedger` — the stream-resume dedupe law.  The gateway
  records the token text the caller has already observed; a failover
  re-dispatch replays the call from the start on the surviving replica
  (the identical prompt rides the prefix cache there), and the ledger
  suppresses exactly the already-delivered prefix of the replayed
  stream, so the caller observes ONE contiguous stream — no duplicated,
  no missing tokens (byte-exact for deterministic decode; offset-exact
  otherwise).

Delivery guarantees these pieces add up to:
**at-least-once placement** (a call may be published to more than one
replica across failovers/hedges), **at-most-once terminal delivery**
(the caller consumes exactly one terminal: the old correlation id is
cancel-tombstoned before every re-dispatch, and each attempt runs under
a FRESH correlation id, so a zombie replica that resumes consuming
faults the orphaned call at its admission gate instead of executing it).
"""

from __future__ import annotations

from calfkit_tpu_torch.effects import hotpath

from dataclasses import dataclass
from typing import TYPE_CHECKING

from calfkit_tpu_torch import cancellation

if TYPE_CHECKING:  # pragma: no cover
    from calfkit_tpu_torch.fleet.registry import Replica

__all__ = ["FailoverPolicy", "StreamLedger", "placement_verdict"]

PLACEMENT_ALIVE = "alive"


@dataclass(frozen=True)
class FailoverPolicy:
    """Caller-side in-flight recovery knobs, applied by
    ``AgentGateway.execute``/``AgentGateway.stream`` on fleet-routed
    clients.  Failover re-dispatches carry the REMAINING deadline (the
    mesh deadline is absolute — a recovered call never gets extra
    budget), run under a fresh correlation id with the dead replica
    excluded from placement, and cancel-tombstone the old correlation so
    a zombie replica cannot execute the orphaned run."""

    # how often (real seconds) the supervisor re-checks an outstanding
    # placement against placement_verdict while awaiting its terminal.
    # The stall a probe can detect is bounded below by the registry's
    # stale_after — probing faster than the heartbeat interval buys
    # nothing but wakeups.
    probe_interval: float = 0.25
    # dead-placement re-dispatches one call may burn (the original
    # attempt is not counted).  Retriable FAULTS are governed by the
    # client's RetryPolicy, not this bound — a fault is an answer, a
    # dead placement is silence.
    max_failovers: int = 2
    # optional tail-latency hedge: with no terminal after this many
    # seconds (on the wall_clock seam, measured from dispatch), a
    # duplicate call is placed on a DIFFERENT replica; the first
    # terminal wins and the loser is cancelled through the ordinary
    # cancel propagation.  None = off.  Hedging applies to execute()
    # only — a hedged stream would interleave two token streams.
    hedge_after: "float | None" = None


@hotpath
def placement_verdict(
    replica: "Replica | None", *, stale_after: float,
    now: "float | None" = None,
) -> str:
    """THE dead-placement law: is a run placed on ``replica`` still being
    served?  Returns ``"alive"`` or the first death reason —
    ``"dead:gone"`` (advert vanished from the directory without a drain),
    ``"dead:stale"`` (heartbeat lapsed past ``stale_after``: process
    kill, OOM, wedged heartbeat loop), ``"dead:unready"`` (the advert
    flipped unready WITHOUT draining — the wedge watchdog's signature).

    Draining and merely-busy replicas are alive: drain finishes in-flight
    work by contract, and load is the router's problem, not failover's.
    ``None`` (replica not in the registry view) is ``dead:gone``."""
    if replica is None:
        return "dead:gone"
    if now is None:
        now = cancellation.wall_clock()
    if replica.age(now) >= stale_after:
        return "dead:stale"
    if not replica.stats.ready and not replica.stats.draining:
        return "dead:unready"
    return PLACEMENT_ALIVE


class StreamLedger:
    """The stream-resume dedupe law (one contiguous stream across
    failover attempts).

    ``filter(chunk)`` is fed every TokenStep text chunk of the CURRENT
    attempt, in order, and returns the portion the caller has not yet
    observed (possibly ``""``).  ``begin_attempt()`` resets the replay
    cursor when a failover re-dispatch starts: the new replica replays
    the answer from the start, and exactly ``len(self.text)`` characters
    of it are suppressed before delivery resumes.

    The law is OFFSET-exact: with deterministic decode (the fleet's
    greedy default) the replayed prefix is byte-identical and the caller
    cannot tell a failover happened; with sampled decode the suffix past
    the offset is delivered as generated (documented in
    the robustness notes).

    The ledger can only be as contiguous as DELIVERY: the hub's per-run
    step queue drops oldest past its bound, so a consumer lagging far
    enough to lose token events was observing a gapped stream before any
    failover — the ledger records what the caller actually saw, and the
    resumed offset aligns to that, not to the un-dropped generation.
    Keep consuming the stream promptly (the pre-existing contract for
    lossless token telemetry)."""

    def __init__(self) -> None:
        # everything the caller has observed, across all attempts
        self.text = ""
        # characters seen from the current attempt's stream so far
        self._attempt_seen = 0

    @property
    def delivered(self) -> int:
        return len(self.text)

    def begin_attempt(self) -> None:
        self._attempt_seen = 0

    @hotpath
    def filter(self, chunk: str, offset: "int | None" = None) -> str:
        """The not-yet-observed suffix of ``chunk`` (empty while the
        replay is still inside the already-delivered prefix).

        ``offset`` is the chunk's ABSOLUTE char offset within
        the attempt's answer when the emitter stamped it
        (``TokenStep.offset``): a decode-from-offset RESUME stamps its
        first chunk at the delivered-prefix length — the ledger then
        suppresses nothing, because nothing was re-generated — while a
        re-generating attempt stamps from 0 and the replayed prefix is
        trimmed exactly.  ``None`` (older emitters) falls back to
        the cumulative chars-seen-this-attempt law, which is identical
        for replay-from-zero streams."""
        start = offset if offset is not None else self._attempt_seen
        self._attempt_seen = start + len(chunk)
        overlap = len(self.text) - start  # chars of chunk already observed
        if overlap >= len(chunk):
            return ""
        fresh = chunk[overlap:] if overlap > 0 else chunk
        self.text += fresh
        return fresh
