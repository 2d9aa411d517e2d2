"""Wire-protocol constants: header names, kind vocabularies, header decode.

This module is the single authority for what travels in Kafka record *headers*
(bodies are defined in :mod:`calfkit_tpu_torch.models`).  It depends on nothing else
in the package by design, mirroring the reference's dependency-free protocol
module (reference: calfkit/_protocol.py:1-118).

Header model
------------
Every envelope-bearing record carries:

- ``x-mesh-emitter``   — ``<node_kind>/<node_name>`` of the publishing node
- ``x-mesh-kind``      — :data:`MessageKind`: ``call`` | ``return`` | ``fault``
- ``x-mesh-wire``      — :data:`WireKind`: body schema discriminator
                         (``envelope`` | ``step``)
- ``x-mesh-route``     — the route string the publisher addressed
- ``x-mesh-task``      — task id (uuid); equals the partition key's source
- ``x-mesh-correlation`` — correlation id of the whole run (client-minted)
- ``x-mesh-error-type`` — fault records only: the typed fault code
- ``x-mesh-trace``     — distributed-trace id (client-minted, equals the
                         correlation id by convention)
- ``x-mesh-span``      — the EMITTING hop's span id; the receiving hop
                         parents its own span to it
- ``x-mesh-deadline``  — absolute wall-clock deadline (epoch seconds,
                         decimal string), minted by the client from its
                         timeout and forwarded by every hop.  A hop that
                         receives an already-expired call records a typed
                         ``mesh.deadline_exceeded`` fault instead of
                         executing — work for a dead caller is the mesh's
                         most expensive no-op.

Headers are advisory routing/telemetry metadata; the envelope body is always
authoritative.  Consumers must tolerate missing headers (a ``None`` decode).

The ``cancel`` message kind carries no envelope body: it is a pure header
record (correlation id + task key) that asks every in-process cancellation
target along the run's path — engines, long-running handlers — to abandon
work for that correlation id.  Each hop re-publishes the cancel to the
topics it sent the run's calls to, so it follows the run across process
boundaries; a tombstone guards work the targets cannot see yet (see
:mod:`calfkit_tpu_torch.cancellation`).
"""

from __future__ import annotations

from typing import Final, Literal

# --------------------------------------------------------------------------- #
# header names
# --------------------------------------------------------------------------- #

HDR_EMITTER: Final = "x-mesh-emitter"
HDR_KIND: Final = "x-mesh-kind"
HDR_WIRE: Final = "x-mesh-wire"
HDR_ROUTE: Final = "x-mesh-route"
HDR_TASK: Final = "x-mesh-task"
HDR_CORRELATION: Final = "x-mesh-correlation"
HDR_ERROR_TYPE: Final = "x-mesh-error-type"
HDR_TRACE: Final = "x-mesh-trace"
HDR_SPAN: Final = "x-mesh-span"
HDR_DEADLINE: Final = "x-mesh-deadline"
# failure recovery: marks a call record as a failover
# re-dispatch or a hedge duplicate ("failover" | "hedge").  Describes
# THIS placement only — hops do not forward it downstream; the serving
# agent counts arrivals into its engine-stats advert (FAILOVER/HEDGE in
# ``ck stats``).
HDR_ATTEMPT: Final = "x-mesh-attempt"
# caller liveness lease: "<lease_id>:<ttl_s>" — the caller's
# process-level lease, minted once per client and forwarded by every hop
# (like the deadline: downstream tool calls run on the original caller's
# behalf).  While any leased run is outstanding the caller heartbeats the
# compacted CALLER_LIVENESS_TOPIC; an engine whose run's lease lapses
# past its TTL reaps the run as an orphan (typed ``mesh.orphaned``) —
# the server-side half of failure recovery, covering fire-and-forget
# ``send()`` that no client-side supervisor can.
HDR_LEASE: Final = "x-mesh-lease"
# priority class: "interactive" | "batch" — the caller's QoS
# class, minted by the client and forwarded by every hop (downstream
# tool calls run on the original caller's behalf, so they inherit its
# class).  Under overload the mesh degrades SELECTIVELY: batch-class
# work sheds first, reaps first, and rate-limits first.  A corrupt or
# missing header degrades to the DEFAULT class (interactive — batch is
# an explicit opt-in to lower priority; legacy callers must not be
# demoted) and never faults delivery (the header-degradation law).
HDR_PRIORITY: Final = "x-mesh-priority"
# run identity: "<run_id>:<attempt_no>" — the run_id is minted
# ONCE per logical ``execute()``/``stream()`` call and carried VERBATIM
# across retries, failover re-dispatches, hedge duplicates, and
# decode-from-offset resumes; the attempt counter beside it increments
# per placement.  Forwarded by every hop (like the deadline and the
# lease: downstream tool calls belong to the same logical run), unlike
# ``x-mesh-attempt`` which describes one placement only.  A corrupt
# header degrades to an UN-LINKED run — never a shared bogus run id,
# never a delivery fault (the header-degradation law).
HDR_RUN: Final = "x-mesh-run"

ALL_HEADERS: Final = (
    HDR_EMITTER,
    HDR_KIND,
    HDR_WIRE,
    HDR_ROUTE,
    HDR_TASK,
    HDR_CORRELATION,
    HDR_ERROR_TYPE,
    HDR_TRACE,
    HDR_SPAN,
    HDR_DEADLINE,
    HDR_ATTEMPT,
    HDR_LEASE,
    HDR_PRIORITY,
    HDR_RUN,
)

# the QoS class vocabulary, ordered best-first; everything
# that ranks, sheds, or renders by class iterates THIS tuple so the
# order is defined in exactly one place
PRIORITY_CLASSES: Final = ("interactive", "batch")
DEFAULT_PRIORITY: Final = "interactive"

# --------------------------------------------------------------------------- #
# kind vocabularies
# --------------------------------------------------------------------------- #

NodeKind = Literal["agent", "tool", "consumer", "toolbox", "client", "worker"]
MessageKind = Literal["call", "return", "fault", "cancel"]
WireKind = Literal["envelope", "step", "span"]

MESSAGE_KINDS: Final = ("call", "return", "fault", "cancel")
WIRE_KINDS: Final = ("envelope", "step", "span")

# --------------------------------------------------------------------------- #
# decode helpers
# --------------------------------------------------------------------------- #


def decode_header_str(value: bytes | str | None) -> str | None:
    """Decode a raw header value to ``str`` (headers may arrive as bytes)."""
    if value is None:
        return None
    if isinstance(value, bytes):
        try:
            return value.decode("utf-8")
        except UnicodeDecodeError:
            return None
    return value


def header_map(raw: dict[str, bytes | str] | None) -> dict[str, str]:
    """Normalize a raw header mapping to ``str -> str``, dropping undecodables."""
    out: dict[str, str] = {}
    for k, v in (raw or {}).items():
        s = decode_header_str(v)
        if s is not None:
            out[k] = s
    return out


def format_deadline(epoch_s: float) -> str:
    """Encode an absolute wall-clock deadline for the wire (ms precision:
    cross-host clock skew dwarfs anything finer)."""
    return f"{epoch_s:.3f}"


def parse_deadline(value: "bytes | str | None") -> "float | None":
    """Decode an ``x-mesh-deadline`` header value; ``None`` for a missing
    or malformed header (a corrupt deadline degrades to un-deadlined, it
    must never fault the delivery)."""
    s = decode_header_str(value)
    if not s:
        return None
    try:
        deadline = float(s)
    except ValueError:
        return None
    # NaN/inf are not deadlines; negative epochs are clock garbage
    if deadline != deadline or deadline in (float("inf"), float("-inf")):
        return None
    return deadline if deadline > 0 else None


def format_lease(lease_id: str, ttl_s: float) -> str:
    """Encode a caller lease for the wire: ``<lease_id>:<ttl_s>`` (lease
    ids are hex — never contain the separator)."""
    return f"{lease_id}:{ttl_s:.3f}"


def parse_lease(value: "bytes | str | None") -> "tuple[str, float] | None":
    """Decode an ``x-mesh-lease`` header to ``(lease_id, ttl_s)``; None
    for a missing or malformed header (a corrupt lease degrades to
    un-leased — the pre-lease behavior — and must never fault delivery)."""
    s = decode_header_str(value)
    if not s or ":" not in s:
        return None
    lease_id, _, raw_ttl = s.rpartition(":")
    try:
        ttl = float(raw_ttl)
    except ValueError:
        return None
    # NaN/inf/non-positive TTLs are not leases
    if ttl != ttl or ttl in (float("inf"), float("-inf")) or ttl <= 0:
        return None
    return (lease_id, ttl) if lease_id else None


def format_run(run_id: str, attempt: int) -> str:
    """Encode run identity for the wire: ``<run_id>:<attempt_no>`` (run
    ids are hex — never contain the separator)."""
    return f"{run_id}:{attempt:d}"


def parse_run(value: "bytes | str | None") -> "tuple[str, int] | None":
    """Decode an ``x-mesh-run`` header to ``(run_id, attempt_no)``; None
    for a missing or malformed header (a corrupt run header degrades to
    an UN-LINKED run — never a shared bogus run id, never a delivery
    fault)."""
    s = decode_header_str(value)
    if not s or ":" not in s:
        return None
    run_id, _, raw_attempt = s.rpartition(":")
    # int(), not float(): "1.5", "nan", "inf" are not attempt counters
    try:
        attempt = int(raw_attempt)
    except ValueError:
        return None
    if attempt < 0:
        return None
    return (run_id, attempt) if run_id else None


def format_priority(priority: str) -> str:
    """Encode a priority class for the wire (identity today; the single
    authority exists so a future vocabulary change has one mint site)."""
    return priority


def parse_priority(value: "bytes | str | None") -> "str | None":
    """Decode an ``x-mesh-priority`` header to a class name; ``None``
    for a missing, undecodable, or out-of-vocabulary value (a corrupt
    class degrades to the DEFAULT class downstream — it must never fault
    delivery, and it must never invent a third class)."""
    s = decode_header_str(value)
    if s in PRIORITY_CLASSES:
        return s
    return None


def emitter_header(node_kind: str, node_name: str) -> str:
    return f"{node_kind}/{node_name}"


def parse_emitter(value: str | None) -> tuple[str | None, str | None]:
    """Split ``<kind>/<name>`` (name may itself contain ``/``-free chars only)."""
    if not value or "/" not in value:
        return None, None
    kind, _, name = value.partition("/")
    return (kind or None), (name or None)


def wire_kind_of(headers: dict[str, str]) -> str | None:
    return headers.get(HDR_WIRE)


def is_envelope(headers: dict[str, str]) -> bool:
    """Subscriber filter: does this record carry an Envelope body?

    Records without a wire header are treated as envelopes for lenient
    interop; ``step`` records are explicitly not (reference: the
    ``wire_filter`` subscriber filter, calfkit/_protocol.py:89).
    """
    wk = headers.get(HDR_WIRE)
    return wk is None or wk == "envelope"


# --------------------------------------------------------------------------- #
# topic-name validation (Kafka legal-name rules)
# --------------------------------------------------------------------------- #

_TOPIC_LEGAL = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)
MAX_TOPIC_LEN: Final = 249


def is_topic_safe(name: str) -> bool:
    """True iff ``name`` is a legal Kafka topic name.

    Reference: calfkit/_protocol.py:110 (same rules: charset, length, and the
    reserved ``.``/``..`` names).
    """
    if not name or len(name) > MAX_TOPIC_LEN:
        return False
    if name in (".", ".."):
        return False
    return all(c in _TOPIC_LEGAL for c in name)


def require_topic_safe(name: str, *, what: str = "topic") -> str:
    if not is_topic_safe(name):
        raise ValueError(
            f"{what} {name!r} is not a legal topic name "
            f"(allowed: [a-zA-Z0-9._-], max {MAX_TOPIC_LEN} chars)"
        )
    return name


# --------------------------------------------------------------------------- #
# framework topic layout
# --------------------------------------------------------------------------- #
# One place computes every per-node topic name so that provisioning, workers,
# clients and the control plane all agree (reference spreads this across
# nodes/base.py and provisioning/provisioner.py; centralizing it is deliberate).


def agent_input_topic(name: str) -> str:
    return require_topic_safe(f"agent.{name}.private.input")


def agent_return_topic(name: str) -> str:
    return require_topic_safe(f"agent.{name}.private.return")


def agent_replica_topic(name: str, instance_id: str) -> str:
    """The replica-ADDRESSED input topic: one per engine-backed
    agent instance, consumed only by that instance.  The shared
    ``agent_input_topic`` load-balances blindly via consumer-group
    membership; the fleet router publishes here instead when a routing
    policy picked a specific replica (least-loaded, power-of-two,
    prefix-affinity).  The shared topic remains the fallback for meshes
    with no control plane or no live replica adverts."""
    return require_topic_safe(f"agent.{name}.replica.{instance_id}.private.input")


def agent_publish_topic(name: str) -> str:
    return require_topic_safe(f"agent.{name}.events")


def tool_input_topic(name: str) -> str:
    return require_topic_safe(f"tool.{name}.input")


def tool_publish_topic(name: str) -> str:
    return require_topic_safe(f"tool.{name}.output")


def toolbox_input_topic(name: str) -> str:
    return require_topic_safe(f"mcp_server.{name}.input")


def toolbox_publish_topic(name: str) -> str:
    return require_topic_safe(f"mcp_server.{name}.output")


def client_inbox_topic(client_id: str) -> str:
    return require_topic_safe(f"mesh.client.{client_id}.inbox")


AGENTS_TOPIC: Final = "mesh.agents"
CAPABILITIES_TOPIC: Final = "mesh.capabilities"
ENGINE_STATS_TOPIC: Final = "mesh.engine_stats"
# compacted span stream (key = trace_id/span_id: compaction dedupes
# re-emissions; spans are one-shot keys, so production clusters should
# ALSO set time retention — cleanup.policy=compact,delete — to bound
# total growth; see docs/observability.md)
TRACES_TOPIC: Final = "mesh.traces"
# compacted caller-liveness beats: key = lease id, value =
# the compact beat JSON (calfkit_tpu_torch.leases.beat_payload); tombstone =
# clean caller departure (outstanding leased runs orphan immediately)
CALLER_LIVENESS_TOPIC: Final = "mesh.caller_liveness"
# run-scoped observability: compacted per-run records (key =
# run_id, value = RunRecord JSON — every attempt's placement/outcome/
# markers), published by the supervising client when a run finishes, and
# compacted per-agent SLO rollups (key = <agent>@<instance>, value =
# SloRollupRecord JSON) re-derived on the control-plane heartbeat
# cadence.  Like mesh.traces, run keys are one-shot: production clusters
# should pair compaction with time retention to bound growth.
RUNS_TOPIC: Final = "mesh.runs"
SLO_TOPIC: Final = "mesh.slo"


def fanout_state_topic(node_id: str) -> str:
    return require_topic_safe(f"mesh.fanout.{node_id}.state")


def fanout_basestate_topic(node_id: str) -> str:
    return require_topic_safe(f"mesh.fanout.{node_id}.basestate")
