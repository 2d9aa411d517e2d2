"""Engine flight recorder: a bounded ring journal of scheduler events.

The port's own copy of ``calfkit_tpu.observability.flightrec`` (same
event codes, same dump format).  The engine appends a typed, timestamped
event at every scheduling decision (admission, wave formation, page
allocation, eviction, dispatch launch and landing, deferred retirement,
sheds, expiries, orphans, the watchdog, faults), cheap enough to leave on
(``RuntimeConfig.flightrec_events``), and dumps the ring to JSONL only
when asked:

- **engine fault** — an exception crossing the dispatch loop dumps the
  ring next to the traceback; a watchdog trip dumps it too;
- **SIGUSR2** — :func:`install_sigusr2`;
- **on demand** — :meth:`FlightRecorder.dump`, :func:`dump_all`,
  :func:`dump_all_text`.

Dumps land in :func:`default_dump_dir` (``$CALFKIT_FLIGHTREC_DIR``, the
reference's variable).  :func:`parse_dump` reads one back and
:func:`timeline_events` reconstructs one request's lifecycle from it,
keyed on its correlation id.

:meth:`FlightRecorder.append` is O(1) and lock-free: one atomic sequence
draw (``itertools.count`` increments under the GIL at C level), one tuple
store into a preallocated ring slot, no formatting.  Overflow overwrites
the oldest events and is *counted* (``counts()['dropped']``).

Failure policy: recording and dumping are telemetry.  A broken journal
writer must never mask the fault it was trying to document.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import weakref
from typing import Any, Iterable

__all__ = [
    "FlightRecorder",
    "EVENT_NAMES",
    "default_dump_dir",
    "dump_all",
    "dump_all_text",
    "install_sigusr2",
    "journals",
    "timeline_events",
]

# ------------------------------------------------------------ event codes
# One small int per scheduler decision point.  Event tuples are
# (seq, t_perf, code, corr, slot, a, b, note); the meaning of a/b per code
# is documented in ARG_LABELS (and docs/observability.md).
EV_SUBMIT = 0  # request entered a queue            a=prompt_len b=max_new
EV_ADMIT = 1  # short-lane activation               a=prompt_len b=reuse_len
EV_ADMIT_LONG = 2  # long-lane (sp) admission       a=prompt_len
EV_WAVE_FORM = 3  # prefill wave formed             a=rows b=bucket
EV_WAVE_LAND = 4  # prefill wave landed             a=rows b=elapsed_ms
EV_PREFILL_CHUNK = 5  # one chunk of a chunked wave a=idx b=n_chunks
EV_PAGE_ALLOC = 6  # KV pages reserved for a slot   a=pages b=shared_pages
EV_PAGE_FREE = 7  # a slot's page reservation freed
EV_PAGE_EVICT = 8  # prefix-cache eviction ran      a=pages_needed
EV_PREFIX_ACQ = 9  # shared-prefix pages acquired   a=pages
EV_PREFIX_REL = 10  # shared-prefix pages released  a=pages
EV_DISPATCH_LAUNCH = 11  # decode dispatch enqueued a=steps b=rows
EV_DISPATCH_LAND = 12  # decode dispatch synced     a=steps b=wasted
EV_SPEC_TICK = 13  # speculative verify dispatch    a=proposed b=emitted
EV_RETIRE = 14  # request retired (resources freed) a=generated
EV_RETIRE_DEFER = 15  # retired; frees deferred to the in-flight landing
EV_SLOT_FREE = 16  # slot returned to the free list
EV_CANCEL = 17  # consumer-cancelled request reaped
EV_FAULT = 18  # exception crossed the dispatch loop (note=repr)
EV_SHED = 19  # bounded admission refused the submit  a=pending b=limit
EV_EXPIRE = 20  # deadline passed (submit/queue/active) a=overdue_ms
EV_RAGGED_WAVE = 21  # unified dispatch: decode+chunk  a=decode_rows b=chunk_rows
EV_WEDGE = 22  # dispatch-progress watchdog tripped  a=stalled_ms b=pending
EV_ORPHAN = 23  # caller lease lapsed; run reaped    a=lapsed_ms

EVENT_NAMES: tuple[str, ...] = (
    "SUBMIT",
    "ADMIT",
    "ADMIT_LONG",
    "WAVE_FORM",
    "WAVE_LAND",
    "PREFILL_CHUNK",
    "PAGE_ALLOC",
    "PAGE_FREE",
    "PAGE_EVICT",
    "PREFIX_ACQ",
    "PREFIX_REL",
    "DISPATCH_LAUNCH",
    "DISPATCH_LAND",
    "SPEC_TICK",
    "RETIRE",
    "RETIRE_DEFER",
    "SLOT_FREE",
    "CANCEL",
    "FAULT",
    "SHED",
    "EXPIRE",
    "RAGGED_WAVE",
    "WEDGE",
    "ORPHAN",
)

# per-event meaning of the two int payload fields (the dump stays compact
# ints; labels are a render-time concern)
ARG_LABELS: dict[str, tuple[str, str]] = {
    "SUBMIT": ("prompt", "max_new"),
    "ADMIT": ("prompt", "reuse"),
    "ADMIT_LONG": ("prompt", ""),
    "WAVE_FORM": ("rows", "bucket"),
    "WAVE_LAND": ("rows", "ms"),
    "PREFILL_CHUNK": ("chunk", "n_chunks"),
    "PAGE_ALLOC": ("pages", "shared"),
    "PAGE_FREE": ("", ""),
    "PAGE_EVICT": ("needed", ""),
    "PREFIX_ACQ": ("pages", ""),
    "PREFIX_REL": ("pages", ""),
    "DISPATCH_LAUNCH": ("steps", "rows"),
    "DISPATCH_LAND": ("steps", "wasted"),
    "SPEC_TICK": ("proposed", "emitted"),
    "RETIRE": ("generated", ""),
    "RETIRE_DEFER": ("generated", ""),
    "SLOT_FREE": ("", ""),
    "CANCEL": ("", ""),
    "FAULT": ("", ""),
    "SHED": ("pending", "limit"),
    "EXPIRE": ("overdue_ms", ""),
    "RAGGED_WAVE": ("decode_rows", "chunk_rows"),
    "WEDGE": ("stalled_ms", "pending"),
    "ORPHAN": ("lapsed_ms", ""),
}

# batch-scoped events a request's timeline borrows from its active window
# (they have no corr of their own but describe dispatches/waves that
# covered the request's slot)
_BATCH_EVENTS = {
    "WAVE_FORM",
    "WAVE_LAND",
    "PREFILL_CHUNK",
    "DISPATCH_LAUNCH",
    "DISPATCH_LAND",
    "SPEC_TICK",
    "RAGGED_WAVE",
    "PAGE_EVICT",
    "FAULT",
}
# slot-scoped events included when their slot matches the request's
_SLOT_EVENTS = {"PAGE_FREE", "SLOT_FREE"}


# process-wide registry of live journals: what SIGUSR2 and the /flightrec
# endpoint dump.  WeakSet so an abandoned engine's journal is collectable.
_JOURNALS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()
_SIGUSR2_INSTALLED = False


def default_dump_dir() -> str:
    """Where fault/SIGUSR2 dumps land: ``$CALFKIT_FLIGHTREC_DIR`` else
    ``~/.cache/calfkit_tpu/flightrec``."""
    return os.environ.get("CALFKIT_FLIGHTREC_DIR") or os.path.expanduser(
        "~/.cache/calfkit_tpu/flightrec"
    )


class FlightRecorder:
    """Fixed-capacity ring journal of typed scheduler events.

    ``capacity`` rounds up to a power of two (the append path masks, never
    modulos); ``0`` disables recording entirely — :meth:`append` becomes a
    single attribute check.  Appends may come from the event loop AND the
    decode thread concurrently: the sequence counter is an
    ``itertools.count`` (atomic under the GIL) and each ring slot is
    replaced wholesale with an immutable tuple, so readers never observe a
    torn event — at worst a mix of generations, which :meth:`snapshot`
    re-orders by sequence number.
    """

    __slots__ = ("__weakref__", "_cap", "_mask", "_ring", "_seq", "dumped", "label")

    def __init__(self, capacity: int = 4096, *, label: str = ""):
        if capacity < 0:
            raise ValueError(f"flightrec capacity must be >= 0 (got {capacity})")
        cap = 1
        while cap < capacity:
            cap *= 2
        self._cap = cap if capacity else 0
        self._mask = self._cap - 1
        self._ring: "list[tuple | None]" = [None] * self._cap
        self._seq = itertools.count()
        self.dumped = 0
        self.label = label
        if self._cap:
            with _REGISTRY_LOCK:
                _JOURNALS.add(self)

    # ------------------------------------------------------------- record
    def append(
        self,
        code: int,
        corr: "str | None" = None,
        slot: int = -1,
        a: int = 0,
        b: int = 0,
        note: "str | None" = None,
    ) -> None:
        """O(1) lock-free append — THE hot-path call.  ``corr`` must be a
        precomputed string (or None), never formatted here; ``a``/``b``
        are per-code int payloads (see ARG_LABELS).  ``note`` is for cold
        paths only (faults)."""
        if not self._cap:
            return
        i = next(self._seq)
        self._ring[i & self._mask] = (
            i, time.perf_counter(), code, corr, slot, a, b, note,
        )

    # ------------------------------------------------------------- inspect
    def snapshot(self) -> "list[tuple]":
        """The ring's current events, oldest first (sequence order)."""
        entries = [e for e in self._ring if e is not None]
        entries.sort(key=lambda e: e[0])
        return entries

    def counts(self) -> dict:
        """``{"appended", "dropped", "dumped"}`` — ring overflow is a
        counted signal, not silent truncation."""
        entries = self.snapshot()
        appended = (entries[-1][0] + 1) if entries else 0
        return {
            "appended": appended,
            "dropped": max(0, appended - self._cap),
            "dumped": self.dumped,
        }

    @property
    def capacity(self) -> int:
        return self._cap

    # --------------------------------------------------------------- dump
    def dump_lines(self, *, reason: str = "manual") -> "list[str]":
        """JSONL: one meta header line, then one line per event (oldest
        first).  Event times are converted to wall-clock seconds with an
        anchor taken NOW — good to the drift between construction and
        dump, which is what postmortems need."""
        entries = self.snapshot()
        anchor = time.time() - time.perf_counter()
        counts = self.counts()
        lines = [
            json.dumps(
                {
                    "flightrec": {
                        "label": self.label,
                        "capacity": self._cap,
                        "appended": counts["appended"],
                        "dropped": counts["dropped"],
                        "reason": reason,
                        "pid": os.getpid(),
                        "dumped_at_s": round(anchor + time.perf_counter(), 3),
                    }
                }
            )
        ]
        for seq, t, code, corr, slot, a, b, note in entries:
            event: dict = {
                "seq": seq,
                "t_s": round(anchor + t, 6),
                "event": (
                    EVENT_NAMES[code]
                    if 0 <= code < len(EVENT_NAMES)
                    else f"UNKNOWN_{code}"
                ),
                "corr": corr,
                "slot": slot,
                "a": a,
                "b": b,
            }
            if note is not None:
                event["note"] = note
            lines.append(json.dumps(event))
        return lines

    def dump(self, *, reason: str = "manual", path: "str | None" = None) -> str:
        """Write the JSONL dump; returns the file path.  Callers on fault
        rails must guard this — a broken writer never outranks the
        original fault."""
        if path is None:
            directory = default_dump_dir()
            os.makedirs(directory, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%S")
            name = self.label or "engine"
            path = os.path.join(
                directory,
                f"flightrec-{name}-{os.getpid()}-{stamp}-{id(self):x}.jsonl",
            )
        lines = self.dump_lines(reason=reason)
        # blocking-ok: the dump rails are fault/operator paths (dispatch
        # fault rail, SIGUSR2, /flightrec) — the process is already
        # failing or a human asked; stalling the loop here is accepted
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        self.dumped += 1
        return path


# ----------------------------------------------------- process-wide dumps
def journals() -> "list[FlightRecorder]":
    with _REGISTRY_LOCK:
        return list(_JOURNALS)


def dump_all(*, reason: str = "signal") -> "list[str]":
    """Dump every registered journal to its own file; broken writers are
    skipped (fail-open), successful paths returned."""
    paths: list[str] = []
    for journal in journals():
        try:
            paths.append(journal.dump(reason=reason))
        except Exception:  # noqa: BLE001 - telemetry never faults the caller
            continue
    return paths


def dump_all_text(*, reason: str = "http") -> str:
    """Concatenated JSONL of every registered journal (the ``/flightrec``
    endpoint body); empty string when none are registered."""
    lines: list[str] = []
    for journal in journals():
        try:
            lines.extend(journal.dump_lines(reason=reason))
            journal.dumped += 1
        except Exception:  # noqa: BLE001
            continue
    return "\n".join(lines) + ("\n" if lines else "")


def install_sigusr2() -> bool:
    """Best-effort, idempotent: SIGUSR2 dumps every registered journal to
    :func:`default_dump_dir`.  Returns True when the handler is (already)
    installed; False where signals are unavailable (non-main thread,
    restricted platforms) — callers never fault on this."""
    global _SIGUSR2_INSTALLED
    if _SIGUSR2_INSTALLED:
        return True
    try:
        import signal

        # chain, don't clobber: the host application may already use
        # SIGUSR2 (faulthandler stack dumps, log rotation) — its handler
        # keeps running after ours
        previous = signal.getsignal(signal.SIGUSR2)

        def _handler(signum: int, frame: Any) -> None:
            dump_all(reason="sigusr2")
            if callable(previous):
                try:
                    previous(signum, frame)
                except Exception:  # noqa: BLE001 - their handler, their bug
                    pass

        signal.signal(signal.SIGUSR2, _handler)
    except Exception:  # noqa: BLE001 - no SIGUSR2 here; recording still works
        return False
    _SIGUSR2_INSTALLED = True
    return True


# -------------------------------------------------------------- timeline
def parse_dump(lines: "Iterable[str]") -> "list[dict]":
    """Parse a JSONL dump into event dicts, skipping meta headers and
    undecodable lines (a truncated crash dump should still mostly read)."""
    events: list[dict] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if (
            not isinstance(obj, dict)
            or "event" not in obj
            or not isinstance(obj.get("seq"), int)
        ):
            continue
        events.append(obj)
    events.sort(key=lambda e: e["seq"])
    return events


def timeline_events(events: "list[dict]", corr: str) -> "list[dict]":
    """One request's lifecycle from a parsed dump: every event carrying
    its correlation id, plus the batch-scoped events (waves, dispatches,
    spec ticks, faults) and slot-scoped frees that fall inside its active
    window — a deferred free lands AFTER the request's last own event
    (one-dispatch-late retirement), so the window extends to the slot's
    next SLOT_FREE."""
    own = [e for e in events if e.get("corr") == corr]
    if not own:
        return []
    start = own[0]["seq"]
    end = own[-1]["seq"]
    slot = next((e["slot"] for e in own if e.get("slot", -1) >= 0), -1)
    deferred = any(e["event"] == "RETIRE_DEFER" for e in own)
    freed = any(e["event"] == "SLOT_FREE" for e in own)
    if slot >= 0 and deferred and not freed:
        for e in events:
            if (
                e["seq"] > end
                and e.get("slot") == slot
                and e["event"] in _SLOT_EVENTS
            ):
                end = e["seq"]
                if e["event"] == "SLOT_FREE":
                    break
    selected = {e["seq"]: e for e in own}
    for e in events:
        if e["seq"] < start or e["seq"] > end or e["seq"] in selected:
            continue
        name = e["event"]
        if name in _BATCH_EVENTS or (
            name in _SLOT_EVENTS and slot >= 0 and e.get("slot") == slot
        ):
            selected[e["seq"]] = e
    return [selected[seq] for seq in sorted(selected)]
