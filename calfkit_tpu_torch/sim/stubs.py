"""Engine stand-ins for fleet scenarios, and the simulator's
virtual-latency model.

Everything above the model-client seam is REAL in a simulated fleet: the
mesh, the workers, the node kernels, the control-plane heartbeats, the
router, the client.  Only the inference engine is replaced, because a
real engine's decode thread makes completion ordering a property of the
host scheduler — and the simulator promises byte-identical reports.

- :class:`ServingStubModel` — instant replies; LOOKS engine-backed to
  the fleet machinery (``stats_snapshot`` makes its agent advertise on
  ``mesh.engine_stats`` and subscribe its replica-addressed topic).
- :class:`StreamingStubModel` — word-sized deltas with a deterministic
  mid-stream pause seam (the kill-mid-stream scenarios).
- :class:`BijectiveTokenizer` — token id ↔ character bijection for
  byte-exact resume tests.
- :class:`SimEngineModel` — the simulator's fixed-latency device stub:
  requests occupy one of ``slots`` virtual servers for a service time
  computed purely from the scenario's :class:`~calfkit_tpu_torch.sim.scenario.
  ServiceSpec` and complete on virtual-clock events — hours of fleet
  time cost no host time, and identical seeds replay identical
  timelines.  It sheds with the real typed ``EngineOverloadedError``,
  models a page-aligned prefix cache (hits skip the prefill term), and
  advertises the same counters a real engine heartbeats
  (depth, EWMA dispatch latency, prefix hits, tokens/dispatch).  With
  ``ServiceSpec.pool_pages`` set it also models a bounded KV page pool,
  driving the REAL :class:`~calfkit_tpu_torch.observability.capacity.
  PageLedger` / ``CapacitySampler`` through the engine's ownership
  transitions — so capacity attribution, occupancy timelines, and the
  headroom advert are provable at fleet scale on virtual time
 .
"""

from __future__ import annotations

import asyncio
from typing import Any

from calfkit_tpu_torch import qos
from calfkit_tpu_torch.exceptions import EngineOverloadedError
from calfkit_tpu_torch.fleet.selection import page_aligned_prefix
from calfkit_tpu_torch.observability import capacity
from calfkit_tpu_torch.sim.clock import VirtualClock
from calfkit_tpu_torch.sim.scenario import ServiceSpec

__all__ = [
    "ServingStubModel",
    "StreamingStubModel",
    "BijectiveTokenizer",
    "SimEngineModel",
]


def _estimate_tokens(messages: Any) -> int:
    return sum(len(str(m)) // 4 for m in messages)


# the sim's virtual KV page geometry: tokens per page for the
# stub's deterministic page math — fixed, like the debug preset's
# page_size, so scenario page counts are a pure function of the prompts
SIM_PAGE_TOKENS = 16


def _pages_for(tokens: int) -> int:
    return max(1, -(-int(tokens) // SIM_PAGE_TOKENS))


def _prompt_text(messages: Any) -> str:
    """The latest user-authored text in the turn — what the router's
    affinity key and the stub's prefix model both derive from."""
    for message in reversed(list(messages)):
        for part in reversed(getattr(message, "parts", []) or []):
            content = getattr(part, "content", None)
            if isinstance(content, str) and content:
                return content
    return ""


class ServingStubModel:
    """A scripted model that LOOKS engine-backed to the fleet machinery:
    ``stats_snapshot`` makes its agent advertise on ``mesh.engine_stats``
    (and subscribe its replica-addressed topic) without paying for a real
    inference engine.  ``load`` feeds the queue-depth signal policies
    rank on; ``replies`` counts turns served by THIS replica."""

    def __init__(self, *, text: str = "ok", load: int = 0):
        self.text = text
        self.load = load
        self.replies = 0

    @property
    def model_name(self) -> str:
        return "serving-stub"

    def stats_snapshot(self, *, window: bool = False) -> dict:
        return {
            "model_name": self.model_name,
            "active_requests": self.load,
            "pending_requests": 0,
        }

    async def request(
        self, messages: Any, settings: Any = None, params: Any = None
    ) -> Any:
        from calfkit_tpu_torch.models.messages import (
            ModelResponse,
            TextOutput,
            Usage,
        )

        self.replies += 1
        return ModelResponse(
            parts=[TextOutput(text=self.text)],
            usage=Usage(
                input_tokens=_estimate_tokens(messages), output_tokens=1
            ),
            model_name=self.model_name,
        )


class BijectiveTokenizer:
    """Token id ↔ character bijection for byte-exact resume tests
   : generated id ``i`` decodes to ``chr(0x100 + i)`` and
    encodes back to exactly ``i`` — so re-encoding a delivered prefix
    reproduces the original token ids and greedy decode-from-offset
    parity is literal byte equality (ByteTokenizer's UTF-8 replacement
    chars break the round trip for arbitrary model outputs).  Prompt
    characters below U+0100 encode to their ordinal, within the debug
    preset's 512-token vocab."""

    pad_id = 0
    bos_id = 1
    eos_id = 2

    def encode(self, text: str) -> "list[int]":
        return [
            ord(c) - 0x100 if ord(c) >= 0x100 else ord(c) for c in text
        ]

    def decode(self, ids: "list[int]") -> str:
        return "".join(chr(0x100 + i) for i in ids if i >= 0)


class StreamingStubModel(ServingStubModel):
    """A ServingStubModel whose ``request_stream`` yields word-sized
    deltas and PAUSES after ``pause_after`` of them until ``release`` is
    set — the deterministic mid-stream seam: a scenario observes the
    first delivered tokens, kills the replica, and knows exactly how
    much text the caller saw.  The stream keeps yielding after the kill
    (a dead replica's compute keeps burning); the transport seam drops
    the output."""

    def __init__(
        self,
        *,
        text: str = "alpha beta gamma delta",
        pause_after: int = 1,
        load: int = 0,
    ):
        super().__init__(text=text, load=load)
        self.pause_after = pause_after
        self.release = asyncio.Event()
        self.streamed: list[str] = []

    async def request_stream(
        self, messages: Any, settings: Any = None, params: Any = None
    ) -> Any:
        from calfkit_tpu_torch.engine.model_client import ResponseDone, TextDelta

        words = self.text.split(" ")
        deltas = [
            w + (" " if i < len(words) - 1 else "")
            for i, w in enumerate(words)
        ]
        for i, delta in enumerate(deltas):
            if i == self.pause_after:
                await self.release.wait()
            self.streamed.append(delta)
            yield TextDelta(delta)
            await asyncio.sleep(0)
        response = await super().request(messages, settings, params)
        yield ResponseDone(response)


class SimEngineModel:
    """The simulator's deterministic fixed-latency engine (see module
    docstring).  All time below is VIRTUAL: a request reserves the
    earliest-free of ``service.slots`` virtual servers, computes its
    service span from the :class:`ServiceSpec`, and awaits a completion
    event the clock fires when an advance crosses it.  The host never
    sleeps; the scenario's discrete-event loop is the only scheduler."""

    def __init__(
        self,
        clock: VirtualClock,
        *,
        index: int = 0,
        service: "ServiceSpec | None" = None,
        prefix_page_chars: int = 64,
    ):
        self.clock = clock
        self.index = index
        self.service = service or ServiceSpec()
        self.prefix_page_chars = prefix_page_chars
        self._mult = self.service.multiplier(index)
        # per-virtual-server busy-until horizon (absolute virtual time)
        self._busy: "list[float]" = [0.0] * max(1, self.service.slots)
        # admitted-unfinished requests: run_id -> {"start", "done",
        # "slot", "service_s", "priority", "event", "shed"} — the
        # pending-vs-active split the heartbeat advertises, and the
        # priority-shed victim pool
        self._inflight: "dict[int, dict[str, Any]]" = {}
        self._next_run = 0
        # prefix model: page-aligned prefixes this replica has served
        self._prefix_seen: "set[bytes]" = set()
        # counters (everything the heartbeat / report harvests)
        self.replies = 0
        self.sheds = 0
        # per-class splits: sheds by the VICTIM's class,
        # completions by the finisher's class — the fairness-gate inputs
        self.interactive_sheds = 0
        self.batch_sheds = 0
        self.interactive_replies = 0
        self.batch_replies = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_reused_tokens = 0
        self.decode_tokens = 0
        self.decode_dispatches = 0
        self.busy_virtual_s = 0.0
        self.dispatch_ewma_ms = 0.0
        # virtual timestamp of the last completion this replica served
        # (the report's makespan reads the fleet max — the horizon
        # no-op event must not inflate it)
        self.last_done_at = 0.0
        # page-pool model: when the scenario gives replicas a
        # virtual KV pool, the stub drives the REAL PageLedger and
        # CapacitySampler — the same attribution/occupancy code a paged
        # engine runs — through the same transitions (alloc at admission,
        # transfer at first prefix registration, acquire/release around
        # reuse, evict under pressure).  wall_anchor=False keeps sampler
        # timestamps virtual; every append passes t=clock.now.
        if self.service.pool_pages > 0:
            self.ledger: "capacity.PageLedger | None" = (
                capacity.PageLedger(self.service.pool_pages)
            )
            self.sampler: "capacity.CapacitySampler | None" = (
                capacity.CapacitySampler(
                    self.service.capacity_samples,
                    label=f"sim-r{index}",
                    ledger=self.ledger,
                    wall_anchor=False,
                )
            )
        else:
            self.ledger = None
            self.sampler = None
        self._free_pool = max(0, self.service.pool_pages)
        self._next_page = 0
        # chain key -> resident page ids; insertion order IS the LRU
        # order (zero-ref chains re-append on release), so eviction pops
        # from the front exactly like PrefixCache's LRU
        self._chain_pages: "dict[bytes, tuple[int, ...]]" = {}
        # chain key -> in-flight reference count (a referenced chain is
        # never evictable, mirroring the zero-ref eviction law)
        self._chain_held: "dict[bytes, int]" = {}
        self.peak_pages_in_use = 0

    @property
    def model_name(self) -> str:
        return "sim-engine"

    # ------------------------------------------------------------ signals
    @property
    def active(self) -> int:
        """Admitted-but-unfinished depth (the shed law's input)."""
        return len(self._inflight)

    def _in_service(self) -> int:
        now = self.clock.now
        return sum(
            1 for r in self._inflight.values() if r["start"] <= now
        )

    def stats_snapshot(self, *, window: bool = False) -> dict:
        in_service = self._in_service()
        now = self.clock.now
        queued_batch = sum(
            1
            for r in self._inflight.values()
            if r["start"] > now and r["priority"] == "batch"
        )
        snapshot = {
            "model_name": self.model_name,
            "platform": "sim",
            "active_requests": in_service,
            "pending_requests": len(self._inflight) - in_service,
            "max_batch_size": self.service.slots,
            "decode_tokens": self.decode_tokens,
            "decode_dispatches": self.decode_dispatches,
            "shed_requests": self.sheds,
            # per-class advert keys: the same split a real
            # engine heartbeats, so the router's interactive-depth
            # tiebreak works against sim adverts too
            "interactive_shed": self.interactive_sheds,
            "batch_shed": self.batch_sheds,
            "interactive_pending": (
                len(self._inflight) - in_service - queued_batch
            ),
            "batch_pending": queued_batch,
            "dispatch_ewma_ms": round(self.dispatch_ewma_ms, 6),
            "prefix_hits": self.prefix_hits,
            "prefix_reused_tokens": self.prefix_reused_tokens,
            "prefix_cached_pages": len(self._prefix_seen),
            "tokens_per_dispatch": (
                round(self.decode_tokens / self.decode_dispatches, 6)
                if self.decode_dispatches
                else 0.0
            ),
        }
        if self.ledger is not None:
            # the capacity scalars a paged engine heartbeats,
            # read off the same ledger — sim adverts carry real headroom
            snapshot["pages_total"] = self.ledger.pages_total
            snapshot["pages_in_use"] = self.ledger.pages_in_use
            snapshot["prefix_resident_pages"] = (
                self.ledger.prefix_resident_pages
            )
            snapshot["evictions_window"] = self.ledger.evicted_pages
            snapshot["alloc_stalls"] = self.ledger.alloc_stalls
        return snapshot

    # -------------------------------------------------------------- pages
    def _reserve_pages(self, need: int) -> int:
        """Deterministic pool pressure: take ``need`` pages from the free
        pool, evicting zero-ref LRU chains through the REAL ledger hook
        when short.  A still-short reservation counts a stall and clamps
        — page accounting is telemetry; virtual service proceeds
        regardless, exactly the never-fault-serving contract."""
        assert self.ledger is not None
        if need > self._free_pool:
            for chain in list(self._chain_pages):
                if need <= self._free_pool:
                    break
                if self._chain_held.get(chain):
                    continue  # referenced — not evictable
                pages = self._chain_pages.pop(chain)
                self._chain_held.pop(chain, None)
                # an evicted chain must re-miss (and re-prefill) later:
                # churn is allowed to cost hit rate, and the scenario
                # measures exactly that
                self._prefix_seen.discard(chain)
                for page in pages:
                    self.ledger.evicted(page)
                self._free_pool += len(pages)
            if need > self._free_pool:
                self.ledger.note_stall()
                need = self._free_pool
        self._free_pool -= need
        return need

    # ---------------------------------------------------------- qos shed
    def _preempt_victim(self) -> "int | None":
        """The queued batch request whose eviction reclaims slot horizon
        EXACTLY: it must not have started (``start > now`` — active work
        is never preempted) and must be the tail of its slot
        (``done == busy[slot]``) so subtracting its service time leaves
        no stale downstream reservation.  Among candidates pick the one
        finishing latest (most horizon reclaimed); ties break to the
        earliest-admitted via dict insertion order — deterministic."""
        now = self.clock.now
        best: "int | None" = None
        best_done = -1.0
        for run_id, record in self._inflight.items():
            if record["priority"] != "batch":
                continue
            if record["start"] <= now:
                continue
            if record["done"] != self._busy[record["slot"]]:
                continue
            if record["done"] > best_done:
                best = run_id
                best_done = record["done"]
        return best

    def _shed_inflight(self, run_id: int) -> None:
        """Evict a queued batch victim: reclaim its slot horizon, count
        the shed against the VICTIM's class, and wake its coroutine —
        which observes the flag, undoes its page accounting, and raises
        the retriable shed fault (the caller's RetryPolicy re-drives)."""
        record = self._inflight.pop(run_id)
        record["shed"] = True
        self._busy[record["slot"]] -= record["service_s"]
        self.sheds += 1
        self.batch_sheds += 1
        record["event"].set()

    # ------------------------------------------------------------ serving
    async def request(
        self, messages: Any, settings: Any = None, params: Any = None
    ) -> Any:
        from calfkit_tpu_torch.models.messages import (
            ModelResponse,
            TextOutput,
            Usage,
        )

        spec = self.service
        # priority class: the node kernel set the contextvar
        # from x-mesh-priority before calling the model — the sim runs
        # the REAL delivery path, so the one degradation law applies
        priority = qos.resolve_priority()
        if (
            spec.shed_above is not None
            and len(self._inflight) >= spec.shed_above
        ):
            victim_id = (
                self._preempt_victim() if priority != "batch" else None
            )
            if victim_id is None:
                # shed the ARRIVAL: batch always; interactive only when
                # no queued batch victim exists — the shed-order law
                self.sheds += 1
                if priority == "batch":
                    self.batch_sheds += 1
                else:
                    self.interactive_sheds += 1
                raise EngineOverloadedError(
                    "sim engine overloaded",
                    lane="sim",
                    pending=len(self._inflight),
                    limit=spec.shed_above,
                )
            self._shed_inflight(victim_id)

        prompt = _prompt_text(messages)
        input_tokens = max(1, len(prompt) // 4)
        prefix_hit = False
        key = page_aligned_prefix(prompt, self.prefix_page_chars)
        if key is not None:
            self.prefix_lookups += 1
            if key in self._prefix_seen:
                prefix_hit = True
                self.prefix_hits += 1
                self.prefix_reused_tokens += len(key) // 4
            else:
                self._prefix_seen.add(key)

        prefill_s = (
            0.0 if prefix_hit else spec.prefill_per_token_s * input_tokens
        )
        service_s = (
            spec.base_s + prefill_s + spec.per_token_s * spec.new_tokens
        ) * self._mult
        now = self.clock.now
        slot = min(range(len(self._busy)), key=lambda i: (self._busy[i], i))
        start_at = max(now, self._busy[slot])
        done_at = start_at + service_s
        self._busy[slot] = done_at
        run_id = self._next_run
        self._next_run += 1
        done = asyncio.Event()
        self._inflight[run_id] = {
            "start": start_at,
            "done": done_at,
            "slot": slot,
            "service_s": service_s,
            "priority": priority,
            "event": done,
            "shed": False,
        }
        record = self._inflight[run_id]

        shared: "tuple[int, ...]" = ()
        granted = 0
        if self.ledger is not None:
            if prefix_hit and key is not None and key in self._chain_pages:
                # reuse granted: reference the chain's resident pages
                # (registration may still be in flight on a racing first
                # request — then there is nothing to reference yet)
                shared = self._chain_pages[key]
                self.ledger.acquire(list(shared))
                self._chain_held[key] = self._chain_held.get(key, 0) + 1
            granted = self._reserve_pages(
                _pages_for(
                    spec.new_tokens + (0 if prefix_hit else input_tokens)
                )
            )
            self.ledger.alloc(
                run_id,
                granted,
                f"sim-r{self.index}-{run_id}",
                # the REAL run-identity seam: the node kernel set this
                # from the x-mesh-run header before calling the model
                capacity.current_run.get(),
                "decode",
            )
            self.peak_pages_in_use = max(
                self.peak_pages_in_use, self.ledger.pages_in_use
            )

        self.clock.schedule(done_at, done.set)
        await done.wait()

        if record["shed"]:
            # victim path: a later interactive arrival preempted this
            # queued batch request (``_shed_inflight`` already removed
            # it, reclaimed the slot horizon, and counted the shed).
            # Undo the page accounting this request never consummated,
            # then surface the REAL retriable shed fault so the caller's
            # RetryPolicy re-drives the work.
            if self.ledger is not None:
                if shared:
                    self.ledger.release(list(shared))
                    held = self._chain_held.get(key, 1) - 1
                    if held <= 0:
                        self._chain_held.pop(key, None)
                        if key in self._chain_pages:
                            self._chain_pages[key] = self._chain_pages.pop(
                                key
                            )
                    else:
                        self._chain_held[key] = held
                self.ledger.free(run_id)
                self._free_pool += granted
            if key is not None and not prefix_hit:
                # this request introduced the prefix but never prefilled
                # it to completion — it must re-miss (and re-prefill)
                self._prefix_seen.discard(key)
            raise EngineOverloadedError(
                "sim engine preempted batch request",
                lane="sim",
                pending=len(self._inflight),
                limit=spec.shed_above,
            )

        self._inflight.pop(run_id, None)
        self.replies += 1
        if priority == "batch":
            self.batch_replies += 1
        else:
            self.interactive_replies += 1
        self.last_done_at = max(self.last_done_at, done_at)
        dispatches = max(
            1,
            -(-spec.new_tokens // max(1, spec.steps_per_dispatch)),
        )
        self.decode_tokens += spec.new_tokens
        self.decode_dispatches += dispatches
        self.busy_virtual_s += service_s
        per_dispatch_ms = service_s * 1000.0 / dispatches
        self.dispatch_ewma_ms = (
            per_dispatch_ms
            if self.dispatch_ewma_ms == 0.0
            else 0.8 * self.dispatch_ewma_ms + 0.2 * per_dispatch_ms
        )
        if self.ledger is not None:
            # retirement: drop the shared reference, register the chain
            # off the first finisher's private pages (transfer at
            # refcount 1, then this request's own release — leaving the
            # chain zero-ref resident, evictable), free the rest
            if shared:
                self.ledger.release(list(shared))
                held = self._chain_held.get(key, 1) - 1
                if held <= 0:
                    self._chain_held.pop(key, None)
                    if key in self._chain_pages:
                        # zero-ref again: re-append = move to LRU tail
                        self._chain_pages[key] = self._chain_pages.pop(key)
                else:
                    self._chain_held[key] = held
            elif key is not None and key not in self._chain_pages and granted:
                moved = min(_pages_for(len(key) // 4), granted)
                pages = tuple(
                    range(self._next_page, self._next_page + moved)
                )
                self._next_page += moved
                self.ledger.transfer(run_id, list(pages), [key] * moved)
                self.ledger.release(list(pages))
                self._chain_pages[key] = pages
                granted -= moved
            self.ledger.free(run_id)
            self._free_pool += granted
            if self.sampler is not None:
                in_service = self._in_service()
                self.sampler.append(
                    self.ledger.pages_in_use,
                    self._free_pool,
                    self.ledger.prefix_resident_pages,
                    in_service,
                    len(self._inflight) - in_service,
                    round(spec.new_tokens / dispatches, 6),
                    0.0,  # no analytic HBM model for the virtual device
                    t=self.clock.now,
                )
        return ModelResponse(
            parts=[TextOutput(text=f"sim:r{self.index}:{self.replies}")],
            usage=Usage(
                input_tokens=input_tokens,
                output_tokens=spec.new_tokens,
            ),
            model_name=self.model_name,
        )
