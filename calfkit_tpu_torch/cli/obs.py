"""``ck trace`` / ``ck stats`` / ``ck fleet`` / ``ck timeline`` /
``ck run`` / ``ck slo`` — the operator surface.

``ck trace <correlation-id>`` reads the compacted ``mesh.traces`` topic
and prints the run's per-hop waterfall (trace_id equals the correlation
id by client convention, so the id on any log line or client handle is
the lookup key).  ``ck stats`` reads the ``mesh.engine_stats`` directory
and prints a live table of every engine's serving metrics.
``ck fleet`` reads the SAME directory per-instance: one row
per replica, with exactly the eligibility signals the fleet router
routes on — readiness, drain state, heartbeat age, queue depth,
shed/expired deltas — so "why is this replica (not) getting traffic"
is answerable from the operator's chair.
``ck timeline <correlation-id>`` reconstructs one request's scheduler
lifecycle — admission → waves → spec/overlap dispatches → retirement →
frees — from an engine flight-recorder dump (same correlation id as the
trace, so a fault report's id works for both commands).
``ck run <run-id>`` stitches ONE logical run's attempts —
every retry/failover/hedge/resume placement recorded on the compacted
``mesh.runs`` table — into a single run-level waterfall, joining each
attempt's spans (``mesh.traces``) and flight-recorder events across
replicas: the view ``ck trace``/``ck timeline`` cannot produce, because
each attempt carries its own correlation id.  ``ck slo`` prints the
per-agent windowed run-level SLO rollups from ``mesh.slo``.
``ck capacity [agent]`` is the HBM page view: per-replica
pool/headroom scalars from the same adverts, then the occupancy
timeline (unicode sparklines) and the page-attribution owner breakdown
from the newest local capacity dump — "who holds this replica's HBM,
and could an admission fit right now".

Rendering is split into pure functions (``render_waterfall`` /
``render_stats_table`` / ``render_fleet_table`` / ``render_timeline`` /
``render_run_timeline`` / ``render_slo_table`` /
``render_capacity_table`` / ``render_capacity_timeline`` /
``render_capacity_breakdown``) so tests cover the formatting without a
mesh.
"""

from __future__ import annotations

import asyncio
import glob
import os
from typing import Iterable

from calfkit_tpu_torch import protocol
from calfkit_tpu_torch.cli._common import (
    Argument,
    CliError,
    command,
    echo,
    option,
    resolve_mesh_for_cli,
)
from calfkit_tpu_torch.fleet.registry import DEFAULT_STALE_AFTER
from calfkit_tpu_torch.models.records import (
    ControlPlaneRecord,
    EngineStatsRecord,
    RunRecord,
    SloRollupRecord,
    SpanRecord,
)

_BAR_WIDTH = 32
# the mesh-reading commands' shared options
_MESH = option("--mesh", "mesh_url", help="mesh url (or $CALFKIT_MESH_URL)")
_TIMEOUT = option("--timeout", default=15.0, type=float, show_default=True,
                  help="catch-up timeout (s)")


def _format_table(rows: "list[tuple]") -> str:
    """Shared column-aligned table rendering (stats / fleet / leases —
    one layout authority, not three drifting copies)."""
    widths = [
        max(len(row[i]) for row in rows) for i in range(len(rows[0]))
    ]
    return "\n".join(
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in rows
    )


def _depth_of(span: SpanRecord, by_id: dict[str, SpanRecord]) -> int:
    depth = 0
    seen: set[str] = {span.span_id}
    parent = span.parent_span_id
    while parent and parent in by_id and parent not in seen:
        seen.add(parent)
        depth += 1
        parent = by_id[parent].parent_span_id
    return depth


def render_waterfall(spans: "list[SpanRecord]") -> str:
    """The per-hop waterfall: one line per span, bar positioned on the
    trace's wall-clock window, indented by parent depth."""
    if not spans:
        return "no spans"
    by_id = {s.span_id: s for s in spans}
    t0 = min(s.start_s for s in spans)
    t1 = max(s.start_s + s.duration_ms / 1000.0 for s in spans)
    total_ms = max((t1 - t0) * 1000.0, 0.001)
    lines = [
        f"trace {spans[0].trace_id}  —  {len(spans)} spans, "
        f"{total_ms:.1f} ms end-to-end"
    ]
    for span in sorted(spans, key=lambda s: (s.start_s, s.span_id)):
        offset_ms = (span.start_s - t0) * 1000.0
        left = int(offset_ms / total_ms * _BAR_WIDTH)
        left = min(left, _BAR_WIDTH - 1)
        width = max(
            1,
            int((offset_ms + span.duration_ms) / total_ms * _BAR_WIDTH) - left,
        )
        bar = " " * left + "#" * min(width, _BAR_WIDTH - left)
        indent = "  " * _depth_of(span, by_id)
        flag = "" if span.status == "ok" else f"  !{span.status}"
        lines.append(
            f"{offset_ms:9.1f}ms  [{bar:<{_BAR_WIDTH}}] "
            f"{span.duration_ms:9.1f}ms  {indent}{span.name}"
            f"  ({span.emitter or span.kind}){flag}"
        )
    return "\n".join(lines)


def render_stats_table(records: "Iterable[EngineStatsRecord]") -> str:
    """The live engine table: one row per engine-backed node."""
    rows = [
        (
            "NODE", "MODEL", "TOK/S", "OCC", "BATCH OCC", "TOK/DISP",
            "ACTIVE", "SLOTS",
            "DECODED", "TTFT P50/P99 MS", "GAP P99 MS", "WASTE",
            "QUEUE I/B", "SHED", "EXPIRED", "CANCELS", "ORPHANS",
            "FAILOVER/HEDGE",
            "RUNS/ATT", "WEDGE", "FREC APP/DROP",
        )
    ]
    for r in records:
        lat = r.latency_ms or {}
        ttft = (
            f"{lat.get('ttft_p50', 0):.0f}/{lat.get('ttft_p99', 0):.0f}"
            if lat else "-"
        )
        # overlapped execution health: the p99 inter-dispatch device-idle
        # bubble (should sit at ~0 with overlap on) and the pad tokens
        # one-dispatch-late retirement discarded
        gap = (
            f"{lat.get('dispatch_gap_p99', 0):.2f}"
            if "dispatch_gap_p99" in lat else "-"
        )
        waste = (
            str(r.overlap_wasted_tokens) if r.overlap_dispatch else "off"
        )
        # flight-recorder ring accounting: a growing DROP count means the
        # ring is overwriting history faster than anyone dumps it — raise
        # RuntimeConfig.flightrec_events if postmortems come up short
        fr = r.flightrec
        frec = f"{fr.get('appended', 0)}/{fr.get('dropped', 0)}" if fr else "-"
        # overload-protection health: admission sheds (bounded queues are
        # DOING THEIR JOB — a growing SHED under load beats silent
        # queue-wait growth), deadline expiries, and reaped cancels with
        # the mesh-propagated subset in parentheses.  Once any per-class
        # counter is nonzero the cell splits i/b — under the
        # shed-order law the interactive share should stay 0 while batch
        # work remains sheddable, and this column is where that shows
        shed = str(r.shed_requests) if r.max_pending else "off"
        if r.interactive_shed or r.batch_shed:
            shed = f"i{r.interactive_shed}/b{r.batch_shed}"
        expired = str(r.expired_requests)
        if r.interactive_expired or r.batch_expired:
            expired = f"i{r.interactive_expired}/b{r.batch_expired}"
        # per-class queued depth: "-" until either class queues (pre-QoS
        # adverts and idle engines render identically quiet)
        queue_split = (
            f"i{r.interactive_pending}/b{r.batch_pending}"
            if r.interactive_pending or r.batch_pending else "-"
        )
        cancels = (
            f"{r.cancelled_requests}({r.cancel_propagated})"
            if r.cancel_propagated
            else str(r.cancelled_requests)
        )
        # failure recovery: arrivals that were failover
        # re-dispatches / hedge duplicates — which replicas absorb
        # recovered work — and the wedge watchdog's state: "WEDGED!"
        # while tripped (requests are being faulted retriable), else
        # lifetime trips (requests faulted in parentheses)
        recovery = f"{r.failover_requests}/{r.hedge_requests}"
        # run-scoped observability: run-level arrivals vs
        # every linked placement, counted from the x-mesh-run header —
        # ATT exceeding RUNS is the attempt amplification failover and
        # hedging add on this replica ("-" = no linked arrivals yet)
        runs_att = (
            f"{r.run_requests}/{r.attempt_requests}"
            if r.attempt_requests else "-"
        )
        wedge = (
            "WEDGED!" if r.wedged
            else f"{r.watchdog_trips}({r.watchdog_faulted})"
            if r.watchdog_trips else "-"
        )
        # prefer the per-heartbeat-interval rates: lifetime cumulative
        # tok/s flattens toward the mean (an engine idle for an hour then
        # bursting shows ~0 lifetime) — the window field exists for this
        window = r.window or {}
        tok_s = window.get("tokens_per_second", r.tokens_per_second)
        occupancy = window.get("mean_occupancy", r.mean_occupancy)
        # BATCH OCC: lifetime mean batch occupancy — with ragged waves on
        # it counts absorbed prefill rows as dispatch participants, so
        # this is THE unified-wave fill metric (OCC stays the windowed
        # rate); TOK/DISP is tokens processed (decode + absorbed prefill)
        # per dispatch
        batch_occ = (
            f"{r.mean_occupancy:.2f}"
            + ("*" if r.ragged_waves else "")
        )
        tok_disp = (
            f"{r.tokens_per_dispatch:.1f}" if r.tokens_per_dispatch else "-"
        )
        rows.append(
            (
                r.node_id,
                r.model_name,
                f"{tok_s:.1f}",
                f"{occupancy:.2f}",
                batch_occ,
                tok_disp,
                str(r.active_requests),
                f"{r.max_batch_size - r.free_slots}/{r.max_batch_size}"
                if r.max_batch_size else "-",
                str(r.decode_tokens),
                ttft,
                gap,
                waste,
                queue_split,
                shed,
                expired,
                cancels,
                # caller liveness: runs the server-side
                # reaper abandoned because their caller's lease lapsed —
                # nonzero here means dead callers' work is being
                # reclaimed instead of burning TPU time to its deadline
                str(r.orphaned_requests),
                recovery,
                runs_att,
                wedge,
                frec,
            )
        )
    if len(rows) == 1:
        return "no live engines (is a worker with a local model running?)"
    return _format_table(rows)


def render_fleet_table(
    replicas: "Iterable", *, stale_after: float, now: "float | None" = None
) -> str:
    """One row per replica instance: the router's view of the fleet.

    ``ROUTE`` is the verdict the router's eligibility filter returns for
    a NEW run right now — ``yes``, or the FIRST reason the replica is
    skipped (``drain`` / ``stale`` / ``unready`` / ``shared-only``) —
    computed by the SAME :func:`~calfkit_tpu_torch.fleet.registry.
    eligibility_verdict` the router uses, so this table cannot drift
    from actual routing behavior.  When the DEAD-placement law
    (:func:`~calfkit_tpu_torch.fleet.failover.placement_verdict`)
    declares the replica dead — stale heartbeat, or unready without
    drain — the verdict renders as ``dead(stale)`` / ``dead(unready)``
    with the last-seen heartbeat age in HB AGE S: runs still placed
    there are being failed over, not just new runs routed away.
    SHED/EXPIRED prefer the per-heartbeat-interval delta (``+n``) over
    lifetime values: what matters for routing is whether a replica is
    shedding NOW.  HEADROOM is the pages an admission could
    still obtain — free-list plus evictable zero-ref cache pages —
    straight from :attr:`~calfkit_tpu_torch.fleet.registry.Replica.
    headroom_pages`, ``-`` when the replica advertises no page pool."""
    from calfkit_tpu_torch import cancellation
    from calfkit_tpu_torch.fleet.failover import placement_verdict
    from calfkit_tpu_torch.fleet.registry import eligibility_verdict

    if now is None:
        now = cancellation.wall_clock()
    rows = [
        (
            "MODEL", "NODE", "INSTANCE", "ROUTE", "READY", "DRAIN",
            "HB AGE S", "DEPTH", "ACTIVE", "PENDING", "SLOTS",
            "HEADROOM", "SHED", "EXPIRED", "TOK/S", "PREFIX HIT",
        )
    ]
    for r in replicas:
        s = r.stats
        age = r.age(now)
        verdict = eligibility_verdict(r, stale_after=stale_after, now=now)
        placement = placement_verdict(r, stale_after=stale_after, now=now)
        if placement != "alive":
            # the dead-placement law outranks the routing verdict: this
            # replica isn't merely skipped for new runs — outstanding
            # placements on it are declared dead and failed over
            verdict = f"dead({placement.partition(':')[2]})"
        window = s.window or {}
        shed = (
            f"+{window['shed_requests']}"
            if "shed_requests" in window else str(s.shed_requests)
        )
        expired = (
            f"+{window['expired_requests']}"
            if "expired_requests" in window else str(s.expired_requests)
        )
        tok_s = window.get("tokens_per_second", s.tokens_per_second)
        rows.append(
            (
                s.model_name,
                s.node_id,
                r.instance_id,
                verdict,
                "y" if s.ready else "n",
                "y" if s.draining else "n",
                f"{age:.1f}",
                str(r.queue_depth),
                str(s.active_requests),
                str(s.pending_requests),
                f"{s.max_batch_size - s.free_slots}/{s.max_batch_size}"
                if s.max_batch_size else "-",
                # pages an admission could still obtain —
                # "-" when the replica advertises no page pool (dense
                # layout, pre-capacity record): no signal must not read
                # as a full replica
                str(r.headroom_pages)
                if getattr(r, "headroom_pages", None) is not None
                else "-",
                shed,
                expired,
                f"{tok_s:.1f}",
                # "-" ONLY when the replica shows no sign of a prefix
                # cache at all: a momentarily-evicted cache (0 resident
                # pages, nonzero lifetime hits) must not render like
                # caching-disabled
                str(s.prefix_hits)
                if (
                    s.prefix_cached_pages or s.prefix_hits
                    or s.prefix_reused_tokens
                )
                else "-",
            )
        )
    if len(rows) == 1:
        return (
            "no advertised replicas (is a worker with a local model "
            "running, and the control plane enabled?)"
        )
    return _format_table(rows)


def _parse_spans(items: dict[str, bytes], correlation_id: str) -> list[SpanRecord]:
    spans: list[SpanRecord] = []
    prefix = f"{correlation_id}/"
    for key, value in items.items():
        if not key.startswith(prefix):
            continue
        try:
            spans.append(SpanRecord.from_wire(value))
        except Exception:  # noqa: BLE001 - skip undecodable records, keep the rest
            continue
    return spans


def _parse_engine_stats(items: dict[str, bytes]) -> list[EngineStatsRecord]:
    out: list[EngineStatsRecord] = []
    for value in items.values():
        try:
            wrapped = ControlPlaneRecord.from_wire(value)
            out.append(EngineStatsRecord.model_validate(wrapped.record))
        except Exception:  # noqa: BLE001
            continue
    return sorted(out, key=lambda r: r.node_id)


@command("trace", Argument("correlation_id"), _MESH, _TIMEOUT,
         help="print a run's per-hop trace waterfall")
def trace_command(correlation_id: str, mesh_url: str | None, timeout: float) -> None:
    async def main() -> None:
        mesh = resolve_mesh_for_cli(mesh_url, hosts_worker=False)
        await mesh.start()
        try:
            reader = mesh.table_reader(protocol.TRACES_TOPIC)
            await reader.start(timeout=timeout)
            await reader.barrier(timeout=timeout)
            spans = _parse_spans(reader.items(), correlation_id)
            await reader.stop()
        finally:
            await mesh.stop()
        if not spans:
            raise CliError(
                f"no spans for {correlation_id!r} on {protocol.TRACES_TOPIC} "
                "(run too old for compaction, or tracing not flowing?)"
            )
        echo(render_waterfall(spans))

    asyncio.run(main())


@command("stats", _MESH, _TIMEOUT, help="print live engine serving metrics")
def stats_command(mesh_url: str | None, timeout: float) -> None:
    async def main() -> None:
        mesh = resolve_mesh_for_cli(mesh_url, hosts_worker=False)
        await mesh.start()
        try:
            reader = mesh.table_reader(protocol.ENGINE_STATS_TOPIC)
            await reader.start(timeout=timeout)
            await reader.barrier(timeout=timeout)
            records = _parse_engine_stats(reader.items())
            await reader.stop()
        finally:
            await mesh.stop()
        echo(render_stats_table(records))

    asyncio.run(main())


@command(
    "fleet",
    _MESH,
    _TIMEOUT,
    option(
        "--stale-after",
        # the router's own default, imported so tuning it cannot silently
        # desynchronize the operator table's ROUTE verdicts from routing
        default=DEFAULT_STALE_AFTER,
        type=float,
        show_default=True,
        help="heartbeat age (s) past which a replica is routed around "
        "(match the router's setting)",
    ),
    help="print the live replica fleet per model: readiness, drain, "
    "heartbeat age, queue depth — the router's eligibility view",
)
def fleet_command(
    mesh_url: str | None, timeout: float, stale_after: float
) -> None:
    from calfkit_tpu_torch.fleet.registry import parse_replicas

    async def main() -> None:
        mesh = resolve_mesh_for_cli(mesh_url, hosts_worker=False)
        await mesh.start()
        try:
            reader = mesh.table_reader(protocol.ENGINE_STATS_TOPIC)
            await reader.start(timeout=timeout)
            await reader.barrier(timeout=timeout)
            replicas = parse_replicas(reader.items())
            await reader.stop()
        finally:
            await mesh.stop()
        replicas.sort(key=lambda r: (r.model_name, r.key))
        echo(render_fleet_table(replicas, stale_after=stale_after))

    asyncio.run(main())


# ----------------------------------------------------------------- leases
def render_leases_table(
    items: "dict[str, bytes]", *, now: "float | None" = None
) -> str:
    """The caller-liveness view: one row per lease on the
    compacted ``mesh.caller_liveness`` table — lease id, beat age, TTL,
    and the verdict the engines' orphan reaper would reach RIGHT NOW
    (``live`` / ``lapsed``), computed by the same lapse law
    (``age > ttl``) so the operator table cannot drift from reaping.

    Rows sort by beat age DESCENDING: the silent leases rank
    first — under overload they are exactly the callers the engine's
    lease-aware shed evicts first, so the top of this table is the shed
    order.  A still-live lease past 80% of its TTL is flagged
    ``live (lapsing)``: one more missed beat window and its runs are
    orphan-reap candidates.  Undecodable rows sink to the bottom."""
    import json as _json

    from calfkit_tpu_torch import cancellation

    if now is None:
        now = cancellation.wall_clock()
    rows = [("LEASE", "BEAT AGE S", "TTL S", "VERDICT")]
    parsed: "list[tuple[float, tuple[str, str, str, str]]]" = []
    undecodable: "list[tuple[str, str, str, str]]" = []
    for key in sorted(items):
        try:
            body = _json.loads(items[key])
            beat_at = float(body["beat_at"])
            ttl = float(body["ttl_s"])
        except (ValueError, KeyError, TypeError):
            undecodable.append((key, "?", "?", "undecodable"))
            continue
        age = max(0.0, now - beat_at)
        if age > ttl:
            verdict = "lapsed"
        elif ttl > 0 and age > 0.8 * ttl:
            verdict = "live (lapsing)"
        else:
            verdict = "live"
        parsed.append((age, (key, f"{age:.1f}", f"{ttl:.1f}", verdict)))
    parsed.sort(key=lambda entry: (-entry[0], entry[1][0]))
    rows.extend(row for _, row in parsed)
    rows.extend(undecodable)
    if len(rows) == 1:
        return (
            "no caller leases (no leased client is running, or none has "
            "beaten yet — leases are opt-in via Client(lease_ttl=...))"
        )
    return _format_table(rows)


@command(
    "leases",
    _MESH,
    _TIMEOUT,
    help="print live caller-liveness leases: beat age vs TTL, and the "
    "orphan reaper's live/lapsed verdict per lease",
)
def leases_command(mesh_url: str | None, timeout: float) -> None:
    async def main() -> None:
        mesh = resolve_mesh_for_cli(mesh_url, hosts_worker=False)
        await mesh.start()
        try:
            reader = mesh.table_reader(protocol.CALLER_LIVENESS_TOPIC)
            await reader.start(timeout=timeout)
            await reader.barrier(timeout=timeout)
            items = reader.items()
            await reader.stop()
        finally:
            await mesh.stop()
        echo(render_leases_table(items))

    asyncio.run(main())


# --------------------------------------------------------------- timeline
def render_timeline(events: "list[dict]", correlation_id: str) -> str:
    """One request's flight-recorder lifecycle, one line per event:
    relative time since the first event, the event name, its decoded int
    payload (labels from ``flightrec.ARG_LABELS``), and a ``(batch)``
    marker on wave/dispatch events borrowed from the request's active
    window (they covered its slot but carry no correlation id)."""
    from calfkit_tpu_torch.observability.flightrec import ARG_LABELS

    if not events:
        return "no events"
    t0 = min(e.get("t_s", 0.0) for e in events)
    span_ms = (max(e.get("t_s", 0.0) for e in events) - t0) * 1000.0
    slot = next((e["slot"] for e in events if e.get("slot", -1) >= 0), -1)
    lines = [
        f"timeline {correlation_id}  —  {len(events)} events"
        + (f", slot {slot}" if slot >= 0 else "")
        + f", {span_ms:.1f} ms first→last"
    ]
    for e in events:
        offset_ms = (e.get("t_s", t0) - t0) * 1000.0
        name = e.get("event", "?")
        labels = ARG_LABELS.get(name, ("a", "b"))
        payload = "  ".join(
            f"{label}={e.get(key, 0)}"
            for label, key in zip(labels, ("a", "b"))
            if label
        )
        note = e.get("note")
        if note:
            payload = (payload + "  " if payload else "") + f"note={note}"
        marker = "" if e.get("corr") == correlation_id else "  (batch)"
        lines.append(
            f"{offset_ms:+11.3f}ms  {name:<16}"
            + (f" {payload}" if payload else "")
            + marker
        )
    return "\n".join(lines)


def _newest_dump(directory: str) -> str | None:
    paths = glob.glob(os.path.join(directory, "*.jsonl"))
    return max(paths, key=os.path.getmtime) if paths else None


@command(
    "timeline",
    Argument("correlation_id"),
    option(
        "--dump",
        "dump_path",
        help="dump file (default: newest *.jsonl in $CALFKIT_FLIGHTREC_DIR / "
        "the fault-dump directory)",
    ),
    help="reconstruct one request's scheduler lifecycle from a "
    "flight-recorder dump",
)
def timeline_command(correlation_id: str, dump_path: str | None) -> None:
    from calfkit_tpu_torch.observability import flightrec

    if dump_path is None:
        directory = flightrec.default_dump_dir()
        dump_path = _newest_dump(directory)
        if dump_path is None:
            raise CliError(
                f"no flight-recorder dumps in {directory!r} — trigger one "
                "with SIGUSR2, GET /flightrec, or pass --dump PATH"
            )
        echo(f"reading {dump_path}", err=True)
    try:
        with open(dump_path) as f:
            events = flightrec.parse_dump(f)
    except OSError as exc:
        raise CliError(f"cannot read dump: {exc}") from exc
    selected = flightrec.timeline_events(events, correlation_id)
    if not selected:
        raise CliError(
            f"no events for {correlation_id!r} in {dump_path} "
            "(wrong dump, or the ring overwrote this request — see the "
            "FREC APP/DROP column of `ck stats`)"
        )
    echo(render_timeline(selected, correlation_id))


# --------------------------------------------------- run timeline
def _parse_run_record(
    items: "dict[str, bytes]", run_id: str
) -> "RunRecord | None":
    value = items.get(run_id)
    if value is None:
        return None
    try:
        return RunRecord.from_wire(value)
    except Exception:  # noqa: BLE001 - undecodable record = not found
        return None


def _parse_run_spans(
    items: "dict[str, bytes]", correlation_ids: "Iterable[str]"
) -> "list[SpanRecord]":
    """Every span belonging to ANY of the run's attempts (span keys are
    ``<trace_id>/<span_id>`` and trace_id == the attempt's correlation
    id by client convention — the stitch needs no other join)."""
    wanted = set(correlation_ids)
    spans: "list[SpanRecord]" = []
    for key, value in items.items():
        if key.partition("/")[0] not in wanted:
            continue
        try:
            spans.append(SpanRecord.from_wire(value))
        except Exception:  # noqa: BLE001 - skip undecodable, keep the rest
            continue
    return spans


def render_run_timeline(
    record: "RunRecord",
    spans: "list[SpanRecord]",
    flight_events: "dict[str, list[dict]] | None" = None,
) -> str:
    """The stitched run-level waterfall: one timeline joining
    every attempt's spans and (where a dump is available) flight-recorder
    events, all positioned on the RUN's wall-clock window — so a
    failover reads as attempt 0's bar ending where attempt 1's begins,
    across replicas.  Pure: tests cover it without a mesh."""
    flight_events = flight_events or {}
    by_corr: "dict[str, list[SpanRecord]]" = {}
    for s in spans:
        by_corr.setdefault(s.trace_id, []).append(s)
    starts = [s.start_s for s in spans]
    ends = [s.start_s + s.duration_ms / 1000.0 for s in spans]
    if record.started_at:
        starts.append(record.started_at)
    if record.finished_at:
        ends.append(record.finished_at)
    for rows in flight_events.values():
        starts.extend(e.get("t_s", 0.0) for e in rows)
        ends.extend(e.get("t_s", 0.0) for e in rows)
    t0 = min(starts) if starts else 0.0
    t1 = max(ends) if ends else t0
    total_ms = max((t1 - t0) * 1000.0, 0.001)
    recovery = "".join(
        f", {n} {label}(s)"
        for n, label in (
            (record.failovers, "failover"),
            (record.hedges, "hedge"),
            (record.resumes, "resume"),
            (record.sheds, "shed"),
        )
        if n
    )
    lines = [
        f"run {record.run_id}  —  agent {record.agent or '?'}, "
        f"outcome {record.outcome}"
        + (f" ({record.error_type})" if record.error_type else "")
        + f", {len(record.attempts)} attempt(s)"
        + recovery
        + (
            f", {record.tokens_delivered} tokens"
            if record.tokens_delivered else ""
        )
        + f", {total_ms:.1f} ms end-to-end"
    ]
    for attempt in sorted(record.attempts, key=lambda a: a.attempt_no):
        off_ms = (
            max(0.0, (attempt.started_at - t0) * 1000.0)
            if attempt.started_at else 0.0
        )
        outcome = attempt.outcome + (
            f"({attempt.error_type})" if attempt.error_type else ""
        )
        lines.append(
            f"  attempt {attempt.attempt_no} [{attempt.kind}]  "
            f"corr {attempt.correlation_id[:12] or '?'}  "
            f"placement {attempt.placement or 'shared'}  "
            f"{outcome}  +{off_ms:.1f}ms"
            + (
                f"  {attempt.tokens_delivered} tok"
                if attempt.tokens_delivered else ""
            )
        )
        attempt_spans = by_corr.get(attempt.correlation_id, [])
        by_id = {s.span_id: s for s in attempt_spans}
        for span in sorted(
            attempt_spans, key=lambda s: (s.start_s, s.span_id)
        ):
            offset_ms = (span.start_s - t0) * 1000.0
            left = max(0, min(
                int(offset_ms / total_ms * _BAR_WIDTH), _BAR_WIDTH - 1
            ))
            width = max(
                1,
                int((offset_ms + span.duration_ms) / total_ms * _BAR_WIDTH)
                - left,
            )
            bar = " " * left + "#" * min(width, _BAR_WIDTH - left)
            indent = "  " * _depth_of(span, by_id)
            flag = "" if span.status == "ok" else f"  !{span.status}"
            lines.append(
                f"  {offset_ms:9.1f}ms  [{bar:<{_BAR_WIDTH}}] "
                f"{span.duration_ms:9.1f}ms  {indent}{span.name}"
                f"  ({span.emitter or span.kind}){flag}"
            )
        for e in flight_events.get(attempt.correlation_id, []):
            ev_off = (e.get("t_s", t0) - t0) * 1000.0
            lines.append(
                f"  {ev_off:9.1f}ms  [{'':<{_BAR_WIDTH}}] "
                f"{'':>9}    · flightrec {e.get('event', '?')}"
            )
    return "\n".join(lines)


def show_run_timeline(
    run_id: str,
    mesh_url: "str | None",
    timeout: float,
    dump_path: "str | None" = None,
) -> None:
    """The body of ``ck run <run-id>`` — dispatched from
    :mod:`calfkit_tpu_torch.cli.run` when the single argument is id-shaped
    (32 hex chars; node specs always carry ``:`` / ``.py`` / dots).

    Reads the run's record off ``mesh.runs``, every attempt's spans off
    ``mesh.traces``, and joins flight-recorder events from the newest
    local dump (or ``--dump``) where one exists — the flightrec join is
    strictly best-effort: no dump, no engine events, timeline still
    renders."""
    from calfkit_tpu_torch.observability import flightrec

    async def read_tables() -> "tuple[RunRecord, list[SpanRecord]]":
        mesh = resolve_mesh_for_cli(mesh_url, hosts_worker=False)
        await mesh.start()
        try:
            reader = mesh.table_reader(protocol.RUNS_TOPIC)
            await reader.start(timeout=timeout)
            await reader.barrier(timeout=timeout)
            record = _parse_run_record(reader.items(), run_id)
            await reader.stop()
            if record is None:
                raise CliError(
                    f"no run record for {run_id!r} on "
                    f"{protocol.RUNS_TOPIC} (run still in flight, aged "
                    "out of compaction, or served by a pre-run-ledger "
                    "client?)"
                )
            treader = mesh.table_reader(protocol.TRACES_TOPIC)
            await treader.start(timeout=timeout)
            await treader.barrier(timeout=timeout)
            spans = _parse_run_spans(
                treader.items(),
                [a.correlation_id for a in record.attempts],
            )
            await treader.stop()
        finally:
            await mesh.stop()
        return record, spans

    record, spans = asyncio.run(read_tables())
    # the flightrec join is a local-disk read — it runs OUTSIDE the
    # event loop, and strictly best-effort: no dump, no engine events,
    # the timeline still renders
    flight: "dict[str, list[dict]]" = {}
    path = dump_path or _newest_dump(flightrec.default_dump_dir())
    if path is not None:
        try:
            with open(path) as f:
                events = flightrec.parse_dump(f)
            for a in record.attempts:
                own = [
                    e
                    for e in flightrec.timeline_events(
                        events, a.correlation_id
                    )
                    if e.get("corr") == a.correlation_id
                ]
                if own:
                    flight[a.correlation_id] = own
        except OSError:
            pass
    echo(render_run_timeline(record, spans, flight))


# ------------------------------------------------------------ slo
def _parse_slo(items: "dict[str, bytes]") -> "list[SloRollupRecord]":
    out: "list[SloRollupRecord]" = []
    for value in items.values():
        try:
            wrapped = ControlPlaneRecord.from_wire(value)
            out.append(SloRollupRecord.model_validate(wrapped.record))
        except Exception:  # noqa: BLE001 - skip undecodable records
            continue
    return sorted(out, key=lambda r: (r.agent, r.node_id))


def render_slo_table(records: "Iterable[SloRollupRecord]") -> str:
    """The fleet SLO view: one row per per-agent rollup
    advert — RUN-level numbers (what callers experienced), with the
    attempt amplification failover/hedge adds shown separately.  BURN is
    the window's error-budget burn: observed failure ratio over the
    allowed ratio for the completion objective (>1 = burning ahead of
    budget).  INTERACTIVE/BATCH split the window per class —
    ``ok/runs@p95s`` each — so degraded batch completion under overload
    is visible next to the interactive tail it protects (``-`` = no runs
    of that class in the window, including every pre-QoS rollup)."""
    rows = [
        (
            "AGENT", "NODE", "WINDOW S", "RUNS", "OK", "RATIO",
            "P50/P95/P99 S", "INTERACTIVE", "BATCH", "ATT AMP", "SHED",
            "FAILOVER", "ORPHAN", "BURN",
        )
    ]

    def class_cell(completed: int, runs: int, p95_s: float) -> str:
        if not runs:
            return "-"
        return f"{completed}/{runs}@{p95_s:.2f}s"

    for r in records:
        rows.append(
            (
                r.agent,
                r.node_id or "-",
                f"{r.window_s:.0f}",
                str(r.runs),
                str(r.completed),
                f"{r.completion_ratio:.4f}",
                f"{r.e2e_p50_s:.2f}/{r.e2e_p95_s:.2f}/{r.e2e_p99_s:.2f}",
                class_cell(
                    r.interactive_completed, r.interactive_runs,
                    r.interactive_p95_s,
                ),
                class_cell(r.batch_completed, r.batch_runs, r.batch_p95_s),
                f"{r.attempt_amplification:.2f}",
                f"{r.shed_rate:.3f}",
                f"{r.failover_rate:.3f}",
                f"{r.orphan_rate:.3f}",
                f"{r.error_budget_burn:.2f}",
            )
        )
    if len(rows) == 1:
        return (
            "no SLO rollups (no worker with an agent is publishing, or "
            "no finished runs have been folded yet)"
        )
    return _format_table(rows)


@command(
    "slo",
    _MESH,
    _TIMEOUT,
    help="print per-agent run-level SLO rollups: completion ratio, "
    "end-to-end percentiles, shed/failover/orphan rates, budget burn",
)
def slo_command(mesh_url: "str | None", timeout: float) -> None:
    async def main() -> None:
        mesh = resolve_mesh_for_cli(mesh_url, hosts_worker=False)
        await mesh.start()
        try:
            reader = mesh.table_reader(protocol.SLO_TOPIC)
            await reader.start(timeout=timeout)
            await reader.barrier(timeout=timeout)
            records = _parse_slo(reader.items())
            await reader.stop()
        finally:
            await mesh.stop()
        echo(render_slo_table(records))

    asyncio.run(main())


# ----------------------------------------------------- capacity
_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values: "Iterable[float]", *, width: int = 60) -> str:
    """Pure unicode sparkline of the LAST ``width`` values, scaled
    against the series max.  An all-zero series renders as a flat floor
    of ``▁`` — a drained pool must look flat, not invisible."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    hi = max(vals)
    top = len(_SPARK_CHARS) - 1
    if hi <= 0:
        return _SPARK_CHARS[0] * len(vals)
    return "".join(
        _SPARK_CHARS[min(top, int(v / hi * top + 0.5))] for v in vals
    )


def render_capacity_table(replicas: "Iterable") -> str:
    """Per-replica page-pool scalars, straight from the adverts: the
    fleet-wide "could an admission fit" view.  ``-`` across the page
    columns marks a replica with no pool signal (dense layout or a
    pre-capacity advert) — the same None semantics as
    :attr:`~calfkit_tpu_torch.fleet.registry.Replica.headroom_pages`.
    EVICT is the per-heartbeat-interval eviction delta where the advert
    carries a window, else lifetime."""
    rows = [
        (
            "MODEL", "NODE", "INSTANCE", "PAGES", "IN USE", "RESIDENT",
            "HEADROOM", "EVICT", "STALLS",
        )
    ]
    for r in replicas:
        s = r.stats
        if s.pages_total <= 0:
            rows.append(
                (
                    s.model_name, s.node_id, r.instance_id,
                    "-", "-", "-", "-", "-", "-",
                )
            )
            continue
        rows.append(
            (
                s.model_name,
                s.node_id,
                r.instance_id,
                str(s.pages_total),
                str(s.pages_in_use),
                str(s.prefix_resident_pages),
                str(max(0, s.pages_total - s.pages_in_use)),
                str(s.evictions_window),
                str(s.alloc_stalls),
            )
        )
    if len(rows) == 1:
        return (
            "no advertised replicas (is a worker with a local model "
            "running, and the control plane enabled?)"
        )
    return _format_table(rows)


def render_capacity_breakdown(breakdown: "dict") -> str:
    """The page-attribution ledger view: one summary line (the in-use
    identity ``private + shared = in use``), then the top page owners
    (correlation id / run / lane), the per-lane totals, and the hottest
    shared prefix chains by refcount."""
    lines = [
        f"pages {breakdown.get('pages_in_use', 0)}"
        f"/{breakdown.get('pages_total', 0)} in use"
        f"  (private {breakdown.get('private_pages', 0)}"
        f" + shared {breakdown.get('shared_referenced_pages', 0)};"
        f" resident {breakdown.get('prefix_resident_pages', 0)})"
        f"  headroom {breakdown.get('headroom_pages', 0)}"
        f"  evicted {breakdown.get('evicted_pages', 0)}"
        f"  stalls {breakdown.get('alloc_stalls', 0)}"
    ]
    owners = breakdown.get("by_owner") or []
    if owners:
        rows = [("OWNER", "RUN", "LANE", "PAGES")]
        for o in owners:
            rows.append(
                (
                    str(o.get("corr") or "-"),
                    str(o.get("run") or "-"),
                    str(o.get("lane") or "-"),
                    str(o.get("pages", 0)),
                )
            )
        other = breakdown.get("by_owner_other_pages", 0)
        if other:
            rows.append(("(other)", "-", "-", str(other)))
        lines.append(_format_table(rows))
    lanes = breakdown.get("by_lane") or {}
    if lanes:
        lines.append(
            "lanes   "
            + "  ".join(f"{k}={v}" for k, v in sorted(lanes.items()))
        )
    chains = breakdown.get("by_chain") or []
    if chains:
        parts = [
            f"{str(c.get('chain', '?'))[:12]}×{c.get('refs', 0)}"
            for c in chains
        ]
        other = breakdown.get("by_chain_other_pages", 0)
        if other:
            parts.append(f"(other)×{other}")
        lines.append("chains  " + "  ".join(parts))
    return "\n".join(lines)


def render_capacity_timeline(
    meta: "dict | None", samples: "list[dict]"
) -> str:
    """The occupancy timeline from one capacity dump: a sparkline per
    sampled field (occupancy, free pool, resident prefix pages, batch
    fill, queue, dispatch size, the analytic HBM bytes/token), each with
    its min/max/last so the glyphs have units.  Pure: tests cover it
    without an engine."""
    if not samples:
        return "no capacity samples (is RuntimeConfig.capacity_samples 0?)"
    # capacity.parse_dump hands back the header's inner capacity object
    cap = meta or {}
    header = (
        f"capacity {cap.get('label', '?')}  —  {len(samples)} samples"
    )
    if "appended" in cap:
        header += (
            f" (ring appended {cap.get('appended', 0)},"
            f" dropped {cap.get('dropped', 0)})"
        )
    lines = [header]
    for field in (
        "pages_in_use",
        "pages_free",
        "prefix_resident_pages",
        "active_slots",
        "pending",
        "tokens_per_dispatch",
        "hbm_bytes_per_token",
    ):
        vals = [float(s.get(field, 0)) for s in samples]
        lines.append(
            f"  {field:<22} {sparkline(vals)}"
            f"  min {min(vals):g}  max {max(vals):g}  last {vals[-1]:g}"
        )
    return "\n".join(lines)


def _newest_capacity_dump(directory: str) -> "str | None":
    # capacity dumps share the flight-recorder directory but carry their
    # own prefix — a plain *.jsonl glob would hand back a flightrec dump
    paths = glob.glob(os.path.join(directory, "capacity-*.jsonl"))
    return max(paths, key=os.path.getmtime) if paths else None


@command(
    "capacity",
    Argument("agent", required=False),
    _MESH,
    _TIMEOUT,
    option(
        "--dump",
        "dump_path",
        help="capacity dump file (default: newest capacity-*.jsonl in "
        "$CALFKIT_FLIGHTREC_DIR / the fault-dump directory); with --dump "
        "the mesh is not read at all",
    ),
    help="print page-grain HBM capacity: per-replica pool/headroom from "
    "the adverts, plus the occupancy timeline and owner breakdown from "
    "the newest local capacity dump",
)
def capacity_command(
    agent: "str | None",
    mesh_url: "str | None",
    timeout: float,
    dump_path: "str | None",
) -> None:
    from calfkit_tpu_torch.fleet.registry import parse_replicas
    from calfkit_tpu_torch.observability import capacity, flightrec

    if dump_path is None:
        # fleet half: the advert scalars every replica heartbeats
        async def read_adverts() -> "list":
            mesh = resolve_mesh_for_cli(mesh_url, hosts_worker=False)
            await mesh.start()
            try:
                reader = mesh.table_reader(protocol.ENGINE_STATS_TOPIC)
                await reader.start(timeout=timeout)
                await reader.barrier(timeout=timeout)
                out = parse_replicas(reader.items())
                await reader.stop()
            finally:
                await mesh.stop()
            return out

        replicas = asyncio.run(read_adverts())
        if agent is not None:
            replicas = [
                r
                for r in replicas
                if r.agent_name == agent or r.node_id == agent
            ]
            if not replicas:
                raise CliError(
                    f"no advertised replicas for agent {agent!r}"
                )
        replicas.sort(key=lambda r: (r.model_name, r.key))
        echo(render_capacity_table(replicas))
        # local half, strictly best-effort (same contract as ck run's
        # flightrec join): the timeline/breakdown live in a local dump —
        # co-located operators get them, remote ones still get the table
        path = _newest_capacity_dump(flightrec.default_dump_dir())
        if path is None:
            return
        echo(f"reading {path}", err=True)
    else:
        path = dump_path
    try:
        with open(path) as f:
            meta, samples = capacity.parse_dump(f)
    except OSError as exc:
        if dump_path is None:
            return  # the best-effort join must never fail the table
        raise CliError(f"cannot read dump: {exc}") from exc
    echo(render_capacity_timeline(meta, samples))
    bd = (meta or {}).get("breakdown")
    if bd:
        echo(render_capacity_breakdown(bd))
