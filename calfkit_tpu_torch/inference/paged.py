"""Paged KV-cache management (host side): the page allocator and the
prefix cache.

The port's own copy of ``calfkit_tpu.inference.paged`` (same names, same
behaviour, same chain-hash bytes), so both engines take the same paging
decisions.  The design, in short:

- **Page 0 is the trash page.**  Never allocated.  Block-table rows start
  as zeros, and consolidation scatters from inactive batch rows into page
  0, so a retired slot's stale row can keep "writing" harmlessly after its
  real pages were reused by another request.
- **Reserve at admission.**  A request's whole footprint (``prompt +
  max_new`` tokens, capped by ``max_seq``) is allocated before its prefill;
  if the pool cannot cover it the request waits in the queue.  No
  mid-flight OOM, no preemption.
- Plain host Python, touched only from the engine's scheduler flow, never
  from two threads at once (the discipline of the slot free-list).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

TRASH_PAGE = 0


class PageAllocator:
    """Fixed pool of KV pages; page 0 reserved as the trash page."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._held: dict[int, list[int]] = {}  # slot -> pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def held_slots(self) -> dict[int, int]:
        """slot -> page count currently reserved (public, for stats/tests)."""
        return {slot: len(pages) for slot, pages in self._held.items()}

    def alloc(self, slot: int, n: int) -> list[int] | None:
        """Reserve ``n`` pages for ``slot``; None if the pool can't cover it."""
        if slot in self._held:
            raise ValueError(f"slot {slot} already holds pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._held[slot] = pages
        return pages

    def free(self, slot: int) -> None:
        """Return ``slot``'s pages to the pool (idempotent)."""
        self._free.extend(self._held.pop(slot, ()))

    def transfer_out(self, slot: int, pages: "list[int]") -> None:
        """Move ``pages`` out of ``slot``'s holding WITHOUT freeing them —
        ownership passes to the prefix cache (so a later ``free(slot)``
        cannot return shared pages to the pool under live readers)."""
        held = self._held.get(slot)
        if held is None:
            return
        moving = set(pages)
        self._held[slot] = [p for p in held if p not in moving]

    def give_back(self, pages: "list[int]") -> None:
        """Return cache-owned pages to the pool (prefix-cache eviction)."""
        self._free.extend(pages)


def chain_hashes(prompt: "list[int]", page_size: int) -> "list[bytes]":
    """Position-dependent content hash per FULL page of the prompt:
    hash_i = H(hash_{i-1} || tokens[i*ps:(i+1)*ps]).  Chaining makes a
    page's identity its entire prefix, so equal pages at different
    positions (or after different histories) never alias."""
    import hashlib

    out: list[bytes] = []
    prev = b""
    for i in range(len(prompt) // page_size):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(np.asarray(
            prompt[i * page_size:(i + 1) * page_size], np.int32
        ).tobytes())
        prev = h.digest()
        out.append(prev)
    return out


class PrefixCache:
    """Automatic prefix caching over the page pool: an agent re-sends the
    same instructions and history every turn, and their KV pages would be
    recomputed per turn without this.

    Ownership protocol: a landed request's full-prompt pages transfer from
    the allocator to this cache (``PageAllocator.transfer_out``); live
    requests hold references; zero-reference entries sit in an LRU and are
    evicted back to the allocator when admission runs dry."""

    def __init__(self) -> None:
        self._entries: dict[bytes, int] = {}      # chain hash -> page
        self._hash_of: dict[int, bytes] = {}
        self._refs: dict[int, int] = {}            # live slot references
        self._lru: "OrderedDict[bytes, None]" = OrderedDict()

    @property
    def size(self) -> int:
        return len(self._entries)

    def lookup(self, hashes: "list[bytes]") -> "list[int]":
        """Longest cached chain prefix → its pages, in sequence order."""
        pages: list[int] = []
        for h in hashes:
            page = self._entries.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def acquire(self, pages: "list[int]") -> None:
        for page in pages:
            self._refs[page] += 1
            self._lru.pop(self._hash_of[page], None)

    def release(self, pages: "list[int]") -> None:
        for page in pages:
            self._refs[page] -= 1
            if self._refs[page] <= 0:
                self._lru[self._hash_of[page]] = None

    def register(self, h: bytes, page: int) -> bool:
        """False when the hash is already cached (the caller's duplicate
        page stays private to its slot and frees at retirement)."""
        if h in self._entries:
            return False
        self._entries[h] = page
        self._hash_of[page] = h
        self._refs[page] = 0
        return True

    def evict(
        self, need: int, allocator: PageAllocator, *, ledger=None
    ) -> int:
        """Pop up to ``need`` zero-reference entries (oldest released
        first) back into the allocator's free list.  Evicting a chain's
        middle page strands its suffix entries (unreachable by lookup);
        they drain through this same LRU once released.  ``ledger``, when
        given, is told each evicted page (``ledger.evicted(page)``)."""
        freed = 0
        while freed < need and self._lru:
            h, _ = self._lru.popitem(last=False)
            page = self._entries.pop(h)
            del self._hash_of[page]
            del self._refs[page]
            allocator.give_back([page])
            if ledger is not None:
                ledger.evicted(page)
            freed += 1
        return freed


def pages_needed(total_tokens: int, page_size: int) -> int:
    return -(-total_tokens // page_size)


def table_row(pages: list[int], max_pages: int) -> np.ndarray:
    """A block-table row: allocated page ids, padded with the trash page."""
    row = np.full((max_pages,), TRASH_PAGE, np.int32)
    row[: len(pages)] = pages
    return row
