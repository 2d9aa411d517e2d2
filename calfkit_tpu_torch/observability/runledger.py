"""Run ledger: run-scoped observability across attempts.

Failover and caller leases make runs survive replica and caller death, but every
failover/hedge/resume re-dispatch mints a fresh correlation id — so the
trace, the flight-recorder timeline, and the latency histograms all
describe *attempts*, never the *run* the user experienced.  This module
is the run-level half:

- :class:`RunLedger` — the supervising client's per-run record of every
  attempt (placement, marker kind, typed outcome, queue wait, tokens
  delivered, device time).  Appends are O(1) plain-dict mutations on the
  supervisor hot path (``@hotpath``-annotated so meshlint enforces no
  blocking/logging/formatting there); timestamps are passed IN by the
  caller from the ``cancellation.wall_clock`` seam, never read here.
  Typed :class:`~calfkit_tpu_torch.models.records.RunRecord` models are built
  only on the cold paths (``run_report()``, export).
- :func:`publish_runs_soon` — fire-and-forget compacted export to
  ``mesh.runs`` (key = run_id), the ``publish_spans_soon`` pattern.
- :class:`RunWindowStore` + :func:`rollup_window` — the worker-side fold
  of ``mesh.runs`` records into per-agent sliding windows, and the PURE
  (``@no_wallclock``) rollup math producing
  :class:`~calfkit_tpu_torch.models.records.SloRollupRecord`: run-level
  completion ratio, end-to-end p50/p95/p99, shed/failover/orphan rates,
  attempt amplification, error-budget burn.  Published compacted to
  ``mesh.slo`` on the control-plane heartbeat cadence; rendered by
  ``ck slo``; gateable as dotted metric paths in the sim suite.

Failure policy: the ledger is telemetry.  A corrupt run header degrades
to an un-linked run (``protocol.parse_run`` returns None — the
header-degradation law); a broken export loses records, never requests; fold errors drop
the one record, never the feed.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Iterable

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.effects import hotpath, no_wallclock
from calfkit_tpu_torch.models.records import (
    RunAttemptRecord,
    RunRecord,
    SloRollupRecord,
)

__all__ = [
    "RunLedger",
    "RunWindowStore",
    "publish_runs_soon",
    "rollup_window",
    "run_percentile",
    "DEFAULT_SLO_WINDOW_S",
    "DEFAULT_SLO_COMPLETION_TARGET",
]

# how many runs the client-side ledger retains (LRU; a long-lived client
# process must not grow without bound — finished runs age out oldest
# first once exported)
RUNS_CAP = 4096
# per-agent finished-run window entries the worker-side store retains
WINDOW_CAP = 2048
DEFAULT_SLO_WINDOW_S = 300.0
DEFAULT_SLO_COMPLETION_TARGET = 0.999

# attempt marker vocabulary (RunAttemptRecord.kind)
ATTEMPT_KINDS = ("first", "retry", "failover", "hedge", "resume")


class RunLedger:
    """Per-run attempt ledger on the client supervisor path.

    Hot-path appends mutate plain dicts/lists (no pydantic construction,
    no formatting, no clock reads — timestamps arrive as arguments);
    bounded LRU over run ids.  Cold paths (:meth:`run_report`,
    :meth:`export_record`, :meth:`finished_records`) build the typed
    models.
    """

    def __init__(self, cap: int = RUNS_CAP):
        self._cap = cap
        # run_id -> {"agent", "client_id", "started_at", "finished_at",
        #            "outcome", "error_type", "attempts": [dict, ...]}
        self._runs: "OrderedDict[str, dict[str, Any]]" = OrderedDict()

    # ------------------------------------------------------------ hot path
    @hotpath
    def begin_run(
        self,
        run_id: str,
        *,
        agent: str = "",
        client_id: str = "",
        started_at: float = 0.0,
        priority: str = "interactive",
    ) -> None:
        """O(1): open a run entry (idempotent — a resumed stream's second
        supervisor pass must not wipe recorded attempts)."""
        existing = self._runs.get(run_id)
        if existing is not None:
            self._runs.move_to_end(run_id)
            return
        self._runs[run_id] = {
            "agent": agent,
            "client_id": client_id,
            "started_at": started_at,
            "finished_at": 0.0,
            "outcome": "pending",
            "error_type": "",
            # priority class: the run's EFFECTIVE class as the
            # supervising client resolved it — the `ck slo` per-class fold
            "priority": priority,
            "attempts": [],
        }
        while len(self._runs) > self._cap:
            self._runs.popitem(last=False)

    @hotpath
    def note_attempt(
        self,
        run_id: str,
        *,
        attempt_no: int,
        correlation_id: str,
        kind: str = "first",
        placement: str = "",
        agent: str = "",
        started_at: float = 0.0,
    ) -> None:
        """O(1) append of one placement.  ``correlation_id`` is the join
        key to that attempt's spans and flight-recorder events (trace_id
        == correlation id by client convention) — the ``ck run`` stitch
        depends on it being recorded here."""
        run = self._runs.get(run_id)
        if run is None:
            return
        run["attempts"].append(
            {
                "attempt_no": attempt_no,
                "correlation_id": correlation_id,
                "kind": kind,
                "placement": placement,
                "agent": agent,
                "started_at": started_at,
                "finished_at": 0.0,
                "outcome": "pending",
                "error_type": "",
                "queue_wait_s": 0.0,
                "tokens_delivered": 0,
                "device_time_s": 0.0,
            }
        )

    @hotpath
    def note_outcome(
        self,
        run_id: str,
        correlation_id: str,
        *,
        outcome: str,
        error_type: str = "",
        finished_at: float = 0.0,
        tokens_delivered: int = 0,
        queue_wait_s: float = 0.0,
        device_time_s: float = 0.0,
    ) -> None:
        """Record one attempt's terminal.  Scans attempts newest-first
        (a run holds a handful of attempts; the latest is almost always
        the one terminating) — effectively O(1)."""
        run = self._runs.get(run_id)
        if run is None:
            return
        attempts = run["attempts"]
        for i in range(len(attempts) - 1, -1, -1):
            attempt = attempts[i]
            if attempt["correlation_id"] == correlation_id:
                if attempt["outcome"] != "pending":
                    # first signal wins: a zombie replica's late reply
                    # must not overwrite the supervisor's "superseded"
                    # verdict (and vice versa — whichever landed first
                    # is what the caller experienced)
                    return
                attempt["outcome"] = outcome
                attempt["error_type"] = error_type
                attempt["finished_at"] = finished_at
                if tokens_delivered:
                    attempt["tokens_delivered"] = tokens_delivered
                if queue_wait_s:
                    attempt["queue_wait_s"] = queue_wait_s
                if device_time_s:
                    attempt["device_time_s"] = device_time_s
                return

    @hotpath
    def add_tokens(self, run_id: str, correlation_id: str, n: int) -> None:
        """O(1) streaming token accounting for the attempt (newest-first
        scan, same law as :meth:`note_outcome`)."""
        run = self._runs.get(run_id)
        if run is None:
            return
        attempts = run["attempts"]
        for i in range(len(attempts) - 1, -1, -1):
            attempt = attempts[i]
            if attempt["correlation_id"] == correlation_id:
                attempt["tokens_delivered"] += n
                return

    @hotpath
    def finish_run(
        self,
        run_id: str,
        *,
        outcome: str,
        error_type: str = "",
        finished_at: float = 0.0,
    ) -> None:
        """O(1): close the run with its caller-visible outcome."""
        run = self._runs.get(run_id)
        if run is None:
            return
        run["outcome"] = outcome
        run["error_type"] = error_type
        run["finished_at"] = finished_at

    # ----------------------------------------------------------- cold path
    def run_report(self, run_id: str) -> "RunRecord | None":
        """The typed run-level report (``handle.run_report()``): every
        attempt with its placement, marker, and typed outcome."""
        run = self._runs.get(run_id)
        if run is None:
            return None
        return _build_record(run_id, run)

    def export_record(self, run_id: str) -> "RunRecord | None":
        return self.run_report(run_id)

    def run_ids(self) -> "list[str]":
        return list(self._runs)

    def finished_records(self) -> "list[RunRecord]":
        """Every closed run's record, oldest first (the sim harvest and
        test surface)."""
        return [
            _build_record(run_id, run)
            for run_id, run in self._runs.items()
            if run["outcome"] != "pending"
        ]


def _build_record(run_id: str, run: "dict[str, Any]") -> RunRecord:
    attempts = [RunAttemptRecord(**a) for a in run["attempts"]]
    return RunRecord(
        run_id=run_id,
        agent=run["agent"],
        client_id=run["client_id"],
        started_at=run["started_at"],
        finished_at=run["finished_at"],
        outcome=run["outcome"],
        error_type=run["error_type"],
        priority=run.get("priority", "interactive"),
        attempts=attempts,
        sheds=sum(1 for a in attempts if a.outcome == "shed"),
        failovers=sum(1 for a in attempts if a.kind == "failover"),
        hedges=sum(1 for a in attempts if a.kind == "hedge"),
        resumes=sum(1 for a in attempts if a.kind == "resume"),
        tokens_delivered=sum(a.tokens_delivered for a in attempts),
    )


def publish_runs_soon(
    publish: Any,
    records: "list[RunRecord]",
    tasks: "set[Any]",
    *,
    on_error: "Callable[[BaseException], None] | None" = None,
) -> None:
    """Fire-and-forget compacted export to ``mesh.runs`` (key = run_id)
    — the ``publish_spans_soon`` pattern: the export rides a task held in
    ``tasks`` until done, strictly fail-open (a failed export degrades to
    client-local ``run_report()`` visibility only)."""
    if not records:
        return

    async def export() -> None:
        try:
            for record in records:
                await publish(
                    protocol.RUNS_TOPIC,
                    record.to_wire(),
                    key=record.run_key().encode("utf-8"),
                    headers={protocol.HDR_WIRE: "span"},
                )
        except Exception as exc:  # noqa: BLE001 - telemetry never faults
            if on_error is not None:
                try:
                    on_error(exc)
                except Exception:  # noqa: BLE001
                    pass

    try:
        import asyncio

        task = asyncio.get_running_loop().create_task(export())
        tasks.add(task)  # hold a ref until done (GC safety)
        task.add_done_callback(tasks.discard)
    except Exception:  # noqa: BLE001 - no loop / shutting down: local only
        pass


# --------------------------------------------------------------- rollups
@no_wallclock
def run_percentile(values: "list[float]", q: float) -> float:
    """Deterministic nearest-rank percentile (the sim/report law — no
    interpolation jitter); 0.0 on empty input."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = min(len(ordered) - 1, max(0, int(q * len(ordered))))
    return float(ordered[rank])


@no_wallclock
def rollup_window(
    entries: "Iterable[dict[str, Any]]",
    *,
    agent: str,
    window_end: float,
    window_s: float = DEFAULT_SLO_WINDOW_S,
    node_id: str = "",
    target: float = DEFAULT_SLO_COMPLETION_TARGET,
) -> SloRollupRecord:
    """THE rollup fold: pure math from window entries (one dict per
    finished run — see :meth:`RunWindowStore.fold`) to the per-agent
    SLO record.  ``@no_wallclock`` by contract: the sim gates these
    numbers, so the fold must never observe host time — ``window_end``
    arrives from the caller's clock seam.

    Error-budget burn is the observed failure ratio over the allowed
    failure ratio for the completion objective: burn 1.0 = failing at
    exactly the budgeted rate, >1 = burning ahead of budget.
    """
    lo = window_end - window_s
    runs = 0
    completed = 0
    attempts = 0
    sheds = 0
    failovers = 0
    orphans = 0
    durations: "list[float]" = []
    # per-class sub-folds: entries predating the QoS ledger
    # carry no priority and count as the default class
    class_runs = {"interactive": 0, "batch": 0}
    class_completed = {"interactive": 0, "batch": 0}
    class_durations: "dict[str, list[float]]" = {
        "interactive": [], "batch": [],
    }
    for e in entries:
        if e["finished_at"] < lo:
            continue
        runs += 1
        attempts += max(1, int(e.get("attempts", 1)))
        cls = "batch" if e.get("priority") == "batch" else "interactive"
        class_runs[cls] += 1
        if e.get("outcome") == "ok":
            completed += 1
            class_completed[cls] += 1
        if e.get("sheds", 0):
            sheds += 1
        if e.get("failovers", 0):
            failovers += 1
        if e.get("error_type") == "mesh.orphaned":
            orphans += 1
        duration = max(0.0, e["finished_at"] - e.get("started_at", 0.0))
        durations.append(duration)
        class_durations[cls].append(duration)
    ratio = (completed / runs) if runs else 1.0
    allowed = 1.0 - target
    burn = ((1.0 - ratio) / allowed) if (runs and allowed > 0.0) else 0.0
    return SloRollupRecord(
        agent=agent,
        node_id=node_id,
        window_s=window_s,
        window_end=window_end,
        runs=runs,
        completed=completed,
        completion_ratio=ratio,
        e2e_p50_s=run_percentile(durations, 0.50),
        e2e_p95_s=run_percentile(durations, 0.95),
        e2e_p99_s=run_percentile(durations, 0.99),
        attempts=attempts,
        attempt_amplification=(attempts / runs) if runs else 1.0,
        shed_rate=(sheds / runs) if runs else 0.0,
        failover_rate=(failovers / runs) if runs else 0.0,
        orphan_rate=(orphans / runs) if runs else 0.0,
        slo_completion_target=target,
        error_budget_burn=burn,
        interactive_runs=class_runs["interactive"],
        interactive_completed=class_completed["interactive"],
        interactive_p95_s=run_percentile(class_durations["interactive"], 0.95),
        batch_runs=class_runs["batch"],
        batch_completed=class_completed["batch"],
        batch_p95_s=run_percentile(class_durations["batch"], 0.95),
    )


class RunWindowStore:
    """Worker-side fold of ``mesh.runs`` records into per-agent sliding
    windows (one bounded deque per agent), read by the control-plane
    heartbeat's SLO advert.  Fail-open by construction: an undecodable
    record drops, the feed lives on."""

    def __init__(self, cap: int = WINDOW_CAP):
        self._cap = cap
        self._by_agent: "dict[str, Deque[dict[str, Any]]]" = {}

    def fold(self, key: "bytes | str | None", value: "bytes | str | None") -> None:
        """Fold one ``mesh.runs`` record (tombstones and pending runs are
        skipped — windows hold FINISHED runs only)."""
        if not value:
            return
        try:
            record = RunRecord.from_wire(value)
        except Exception:  # noqa: BLE001 - fail-open: drop the one record
            return
        if record.outcome == "pending" or not record.agent:
            return
        window = self._by_agent.get(record.agent)
        if window is None:
            window = deque(maxlen=self._cap)
            self._by_agent[record.agent] = window
        window.append(
            {
                "started_at": record.started_at,
                "finished_at": record.finished_at,
                "outcome": record.outcome,
                "error_type": record.error_type,
                "priority": record.priority,
                "attempts": len(record.attempts),
                "sheds": record.sheds,
                "failovers": record.failovers,
            }
        )

    def agents(self) -> "list[str]":
        return list(self._by_agent)

    def rollup_for(
        self,
        agent: str,
        *,
        window_end: float,
        window_s: float = DEFAULT_SLO_WINDOW_S,
        node_id: str = "",
        target: float = DEFAULT_SLO_COMPLETION_TARGET,
    ) -> SloRollupRecord:
        return rollup_window(
            self._by_agent.get(agent, ()),
            agent=agent,
            window_end=window_end,
            window_s=window_s,
            node_id=node_id,
            target=target,
        )


# process-wide store: every worker's control plane folds the runs feed
# here (the leases-store pattern — one feed per worker process, shared
# by every hosted agent's SLO advert)
_STORE = RunWindowStore()


def run_window_store() -> RunWindowStore:
    return _STORE


def reset_run_window_store() -> RunWindowStore:
    """Fresh process store (test/sim isolation)."""
    global _STORE
    _STORE = RunWindowStore()
    return _STORE
