"""Capacity observatory: page-grain KV attribution and occupancy timelines.

The port's own copy of ``calfkit_tpu.observability.capacity`` (same names,
same behaviour, same rollups):

- :class:`PageLedger` — a mirror of page *ownership*, kept O(1) at the
  engine's alloc/free/evict sites.  Every KV page is either **private**
  (held by a slot for one request, tagged with its correlation id, run id
  and lane) or **chain-owned** (registered in the prefix cache under its
  chain hash, with a refcount mirroring
  :class:`~calfkit_tpu_torch.inference.paged.PrefixCache`).  The ledger
  allocates nothing: it is telemetry over the allocator's decisions,
  read as ``stats_snapshot()["capacity"]``.
- :class:`CapacitySampler` — a fixed-capacity, lock-free numeric ring
  (``RuntimeConfig.capacity_samples``, 0 = off) appending one occupancy
  sample per dispatch landing; dumps JSONL beside flight-recorder dumps.

Ownership semantics: ``pages_in_use`` counts pages attributed to a LIVE
owner — slot-held private pages plus referenced (refcount >= 1) prefix
pages.  Zero-ref cached pages are not in use: the allocator can evict
them, so ``headroom_pages = pages_total - pages_in_use`` is what an
admission could obtain now.  A drained engine attributes every page to no
owner: ``pages_in_use == 0`` is the leak oracle.

Failure policy: attribution and sampling are telemetry.  A confused
ledger must never fault serving: every mutation tolerates pages or slots
it has never seen.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import weakref
from contextvars import ContextVar
from typing import Any, Iterable

from calfkit_tpu_torch.observability import flightrec

__all__ = [
    "CapacitySampler",
    "PageLedger",
    "SAMPLE_FIELDS",
    "current_run",
    "dump_all_text",
    "hbm_bytes_per_token",
    "hbm_constants",
    "lane_kind",
    "parse_dump",
    "samplers",
]

# run-identity propagation into the engine: the node kernel
# sets this from the ``x-mesh-run`` header next to the deadline/lease
# contextvars, so the in-process engine's submit can tag page ownership
# with the logical run the request serves.  None = un-linked (pre-run
# emitters, direct engine use) — the ledger tags corr only.
current_run: "ContextVar[str | None]" = ContextVar(
    "calfkit_current_run", default=None
)


def lane_kind(history: Any = None, *, long_lane: bool = False) -> str:
    """The owner tag's lane: ``long`` for the sequence-parallel lane,
    ``spec`` when speculation maintains a history for the request,
    ``decode`` otherwise.  (``prefill`` is reserved for chunked
    admission waves that pin pages before activation — the current
    engine activates in the same tick, so it never appears.)"""
    if long_lane:
        return "long"
    return "spec" if history is not None else "decode"


# ------------------------------------------------------------- the ledger
class PageLedger:
    """Owner attribution for every page in a paged-KV pool (see module
    docstring for the ownership semantics).

    Mutations mirror the engine's allocator/prefix-cache transitions:

    - :meth:`alloc` — a slot reserved ``n`` private pages at admission
    - :meth:`transfer` — fresh full-prompt pages moved slot → chain
      ownership at prefix registration (refcount 1: the registering
      request still holds them as shared)
    - :meth:`acquire` / :meth:`release` — chain-page refcounts, exactly
      where ``PrefixCache.acquire/release`` run
    - :meth:`free` — a slot's remaining private pages returned
    - :meth:`evicted` — a zero-ref chain page reclaimed under pressure
      (the hook ``PrefixCache.evict`` calls per freed page)

    Single-writer by construction: the engine mutates pages from the
    event-loop admission path and the decode-thread retirement path,
    never concurrently — the same discipline the allocator itself relies
    on, so the ledger needs no lock.
    """

    __slots__ = (
        "pages_total",
        "_slots",
        "_chain_hash",
        "_chain_refs",
        "_private",
        "_shared_live",
        "_resident",
        "evicted_pages",
        "alloc_stalls",
    )

    def __init__(self, pages_total: int):
        # the allocatable pool (the allocator's pool minus its trash page)
        self.pages_total = max(0, int(pages_total))
        # slot -> (corr, run, lane, private_page_count)
        self._slots: "dict[int, tuple]" = {}
        # chain-owned pages: page -> chain hash / refcount (mirrors
        # PrefixCache._hash_of / _refs)
        self._chain_hash: "dict[int, Any]" = {}
        self._chain_refs: "dict[int, int]" = {}
        self._private = 0  # sum of slot-held private pages
        self._shared_live = 0  # chain pages with refcount >= 1
        self._resident = 0  # chain pages resident (any refcount)
        self.evicted_pages = 0  # cumulative pages reclaimed under pressure
        self.alloc_stalls = 0  # cumulative allocs that needed eviction

    # ----------------------------------------------------------- mutations
    def alloc(
        self,
        slot: int,
        n: int,
        corr: "str | None" = None,
        run: "str | None" = None,
        lane: str = "decode",
    ) -> None:
        """A slot reserved ``n`` private pages.  ``corr``/``run`` must be
        precomputed strings (or None) — never formatted here."""
        prev = self._slots.pop(slot, None)
        if prev is not None:
            self._private -= prev[3]
        self._slots[slot] = (corr, run, lane, n)
        self._private += n

    def free(self, slot: int) -> None:
        """A slot's private pages went back to the pool (idempotent,
        like ``PageAllocator.free``)."""
        prev = self._slots.pop(slot, None)
        if prev is not None:
            self._private -= prev[3]

    def transfer(self, slot: int, pages: "list[int]", hashes: "list") -> None:
        """``len(pages)`` of a slot's private pages became chain-owned
        (prefix registration): each enters at refcount 1 — the
        registering request still references them as shared pages."""
        owner = self._slots.get(slot)
        if owner is not None and pages:
            corr, run, lane, n = owner
            moved = min(n, len(pages))
            self._slots[slot] = (corr, run, lane, n - moved)
            self._private -= moved
        refs = self._chain_refs
        for page, chain in zip(pages, hashes):
            held = refs.get(page)
            if held is not None:
                # already chain-owned (registration collision): acquire
                if held == 0:
                    self._shared_live += 1
                refs[page] = held + 1
                continue
            refs[page] = 1
            self._chain_hash[page] = chain
            self._resident += 1
            self._shared_live += 1

    def acquire(self, pages: "list[int]") -> None:
        """Chain-page refcounts up (prefix reuse granted)."""
        refs = self._chain_refs
        for page in pages:
            held = refs.get(page)
            if held is None:
                continue  # not chain-owned here: tolerate, never fault
            if held == 0:
                self._shared_live += 1
            refs[page] = held + 1

    def release(self, pages: "list[int]") -> None:
        """Chain-page refcounts down (retirement / dropped reuse plan)."""
        refs = self._chain_refs
        for page in pages:
            held = refs.get(page)
            if not held:
                continue  # unknown or already zero: tolerate
            refs[page] = held - 1
            if held == 1:
                self._shared_live -= 1

    def evicted(self, page: int) -> None:
        """A chain page was reclaimed under allocation pressure — the
        per-page hook ``PrefixCache.evict`` calls."""
        held = self._chain_refs.pop(page, None)
        if held is None:
            return
        self._chain_hash.pop(page, None)
        self._resident -= 1
        if held > 0:
            self._shared_live -= 1
        self.evicted_pages += 1

    def note_stall(self) -> None:
        """An admission's page alloc came up short and had to evict (or
        carry back) — the density pressure counter the advert exposes."""
        self.alloc_stalls += 1

    # ----------------------------------------------------------- occupancy
    @property
    def pages_in_use(self) -> int:
        """Pages attributed to a live owner (private + referenced chain
        pages).  0 on a drained engine — the leak oracle."""
        return self._private + self._shared_live

    @property
    def prefix_resident_pages(self) -> int:
        """Chain pages resident in the prefix cache (any refcount)."""
        return self._resident

    @property
    def headroom_pages(self) -> int:
        """Pages an admission could obtain right now: the free list plus
        evictable zero-ref cached pages."""
        return max(0, self.pages_total - self.pages_in_use)

    # ------------------------------------------------------------- rollups
    def breakdown(self, top: int = 8) -> dict:
        """The by-owner / by-chain / by-lane occupancy rollup
        (``stats_snapshot()["capacity"]``).
        Row counts are capped at ``top`` with the remainder summed —
        truncation is counted, never silent.  Reads one-copy snapshots
        (``list()`` of a dict view copies under the GIL), so a reader on the
        event loop never iterates a dict the decode thread is resizing."""
        owners = [o for o in list(self._slots.values()) if o[3] > 0]
        owners.sort(key=lambda o: (-o[3], o[0] or ""))
        by_lane: dict = {}
        for _corr, _run, lane, n in owners:
            by_lane[lane] = by_lane.get(lane, 0) + n
        if self._shared_live:
            by_lane["shared"] = self._shared_live
        chains = sorted(
            list(self._chain_refs.items()), key=lambda kv: (-kv[1], kv[0])
        )
        return {
            "pages_total": self.pages_total,
            "pages_in_use": self.pages_in_use,
            "headroom_pages": self.headroom_pages,
            "private_pages": self._private,
            "shared_referenced_pages": self._shared_live,
            "prefix_resident_pages": self._resident,
            "evicted_pages": self.evicted_pages,
            "alloc_stalls": self.alloc_stalls,
            "by_owner": [
                {"corr": corr, "run": run, "lane": lane, "pages": n}
                for corr, run, lane, n in owners[:top]
            ],
            "by_owner_other_pages": sum(o[3] for o in owners[top:]),
            "by_lane": by_lane,
            "by_chain": [
                {"chain": _chain_str(self._chain_hash.get(page)), "refs": refs}
                for page, refs in chains[:top]
            ],
            "by_chain_other_pages": max(0, self._resident - top),
        }


def _chain_str(chain: Any) -> str:
    """Render a chain hash for rollups: hex for the engine's blake2b
    digests, str() for any other key."""
    if isinstance(chain, (bytes, bytearray)):
        return chain.hex()
    return str(chain)


# ------------------------------------------------------------- the sampler
# one sample per dispatch landing, in tuple position order (after seq, t)
SAMPLE_FIELDS: "tuple[str, ...]" = (
    "pages_in_use",
    "pages_free",
    "prefix_resident_pages",
    "active_slots",
    "pending",
    "tokens_per_dispatch",
    "hbm_bytes_per_token",
)

# process-wide registry of live samplers: what GET /capacity serves.
# WeakSet so an abandoned engine's sampler is collectable.
_SAMPLERS: "weakref.WeakSet[CapacitySampler]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()


class CapacitySampler:
    """Fixed-capacity ring of numeric occupancy samples — flightrec's
    ring discipline applied to capacity timelines.

    ``capacity`` rounds up to a power of two (the append path masks,
    never modulos); ``0`` disables sampling entirely — :meth:`append`
    becomes a single attribute check, the default
    (``RuntimeConfig.capacity_samples = 0``).  Appends come from the
    decode thread (one per dispatch landing); readers on other threads
    never observe a torn sample — each ring slot is replaced wholesale
    with an immutable tuple and :meth:`snapshot` re-orders by sequence.

    ``append(..., t=...)`` takes an explicit timestamp so a caller can
    inject virtual-clock time (``wall_anchor=False`` then keeps dump
    timestamps in virtual seconds instead of anchoring them to the wall
    clock).
    """

    __slots__ = (
        "__weakref__",
        "_cap",
        "_mask",
        "_ring",
        "_seq",
        "dumped",
        "label",
        "ledger",
        "wall_anchor",
    )

    def __init__(
        self,
        capacity: int = 0,
        *,
        label: str = "",
        ledger: "PageLedger | None" = None,
        wall_anchor: bool = True,
    ):
        if capacity < 0:
            raise ValueError(
                f"capacity_samples must be >= 0 (got {capacity})"
            )
        cap = 1
        while cap < capacity:
            cap *= 2
        self._cap = cap if capacity else 0
        self._mask = self._cap - 1
        self._ring: "list[tuple | None]" = [None] * self._cap
        self._seq = itertools.count()
        self.dumped = 0
        self.label = label
        # the ledger whose breakdown rides the dump's meta header (so a
        # capacity dump carries the attribution snapshot it sampled under)
        self.ledger = ledger
        self.wall_anchor = wall_anchor
        if self._cap:
            with _REGISTRY_LOCK:
                _SAMPLERS.add(self)

    # ------------------------------------------------------------- record
    def append(
        self,
        pages_in_use: int,
        pages_free: int,
        prefix_resident_pages: int,
        active_slots: int,
        pending: int,
        tokens_per_dispatch: float,
        hbm_bytes_per_token: float,
        t: "float | None" = None,
    ) -> None:
        """O(1) lock-free append — one sample per dispatch landing.
        Field order is ``SAMPLE_FIELDS``; ``t`` defaults to
        ``time.perf_counter()``."""
        if not self._cap:
            return
        i = next(self._seq)
        self._ring[i & self._mask] = (
            i,
            time.perf_counter() if t is None else t,
            pages_in_use,
            pages_free,
            prefix_resident_pages,
            active_slots,
            pending,
            tokens_per_dispatch,
            hbm_bytes_per_token,
        )

    # ------------------------------------------------------------ inspect
    def snapshot(self) -> "list[tuple]":
        """The ring's current samples, oldest first (sequence order)."""
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
        """JSONL: one meta header line (including the ledger's current
        breakdown when attached), then one line per sample, oldest
        first."""
        entries = self.snapshot()
        anchor = (
            time.time() - time.perf_counter() if self.wall_anchor else 0.0
        )
        counts = self.counts()
        meta: dict = {
            "capacity": {
                "label": self.label,
                "capacity": self._cap,
                "appended": counts["appended"],
                "dropped": counts["dropped"],
                "reason": reason,
                "pid": os.getpid(),
                "fields": list(SAMPLE_FIELDS),
            }
        }
        if self.ledger is not None:
            meta["capacity"]["breakdown"] = self.ledger.breakdown()
        lines = [json.dumps(meta)]
        for entry in entries:
            sample: dict = {
                "seq": entry[0],
                "t_s": round(anchor + entry[1], 6),
            }
            for name, value in zip(SAMPLE_FIELDS, entry[2:]):
                sample[name] = value
            lines.append(json.dumps(sample))
        return lines

    def dump(self, *, reason: str = "manual", path: "str | None" = None) -> str:
        """Write the JSONL dump next to flight-recorder dumps; returns
        the file path.  Telemetry: callers on fault rails must guard."""
        if path is None:
            directory = flightrec.default_dump_dir()
            os.makedirs(directory, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%S")
            name = self.label or "engine"
            path = os.path.join(
                directory,
                f"capacity-{name}-{os.getpid()}-{stamp}-{id(self):x}.jsonl",
            )
        lines = self.dump_lines(reason=reason)
        # blocking-ok: dumps run on operator rails (/capacity, shutdown,
        # explicit CLI asks) — a human asked; stalling here is accepted
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        self.dumped += 1
        return path


# ----------------------------------------------------- process-wide dumps
def samplers() -> "list[CapacitySampler]":
    with _REGISTRY_LOCK:
        return list(_SAMPLERS)


def dump_all_text(*, reason: str = "http") -> str:
    """Concatenated JSONL of every registered sampler (the ``/capacity``
    endpoint body); empty string when none are registered."""
    lines: list[str] = []
    for sampler in samplers():
        try:
            lines.extend(sampler.dump_lines(reason=reason))
            sampler.dumped += 1
        except Exception:  # noqa: BLE001 - telemetry never faults the caller
            continue
    return "\n".join(lines) + ("\n" if lines else "")


def parse_dump(lines: "Iterable[str]") -> "tuple[dict | None, list[dict]]":
    """Parse a capacity JSONL dump into ``(meta, samples)``, skipping
    undecodable lines (a truncated dump should still mostly read).
    ``meta`` is the first header's ``capacity`` object, or None."""
    meta: "dict | None" = None
    samples: list[dict] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if not isinstance(obj, dict):
            continue
        if "capacity" in obj and isinstance(obj["capacity"], dict):
            if meta is None:
                meta = obj["capacity"]
            continue
        if isinstance(obj.get("seq"), int) and SAMPLE_FIELDS[0] in obj:
            samples.append(obj)
    samples.sort(key=lambda s: s["seq"])
    return meta, samples


# --------------------------------------------------- analytic HBM roofline
def hbm_constants(model: Any, quantization: "str | None" = None) -> "tuple[float, float]":
    """``(weight_bytes, kv_bytes_per_context_token)`` — bench's
    ``_perf_model`` roofline constants, precomputed once so the
    per-dispatch sample pays two multiply-adds, not a model walk.
    Weight stream: params x dtype width (int8 halves it, int4 quarters);
    KV read: 2 (K+V) x layers x kv-heads x head_dim x 2 bytes."""
    weight_bytes = float(model.param_count) * {
        "int8": 1.0, "int4": 0.5,
    }.get(quantization, 2.0)
    kv_per_token = (
        2.0 * model.n_layers * model.n_kv_heads * model.head_dim * 2.0
    )
    return weight_bytes, kv_per_token


def hbm_bytes_per_token(
    constants: "tuple[float, float]", ctx: float, effective_bs: float
) -> float:
    """Analytic decode HBM traffic per token at mean context ``ctx``:
    the weight stream amortized over the effective batch plus the
    sequence's own KV read — the same formula bench's ``_perf_model``
    reports, so sampler timelines and bench verdicts agree."""
    weight_bytes, kv_per_token = constants
    return weight_bytes / max(float(effective_bs), 1e-9) + kv_per_token * ctx
