"""The PyTorch port's own copies of the host-side paging and budget helpers
against ``calfkit_tpu``'s: the page allocator and the prefix cache driven
through the same random operation traces, chain hashes byte for byte, the
ragged token-budget arithmetic over a grid, and the runtime's page counts.
"""

import itertools

import numpy as np
import pytest

from calfkit_tpu.inference import paged as JP
from calfkit_tpu.inference import ragged as JR
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime
from calfkit_tpu_torch.inference import paged as TP
from calfkit_tpu_torch.inference import ragged as TR
from calfkit_tpu_torch.inference.config import RuntimeConfig


def _trace(mod, seed, n_pages=24, n_slots=5, steps=300):
    """Drive one package's allocator + prefix cache through a random trace
    of alloc / register+transfer / acquire / release / free / evict →
    everything observable after each step."""
    rng = np.random.default_rng(seed)
    alloc, cache = mod.PageAllocator(n_pages), mod.PrefixCache()
    held: dict[int, list[int]] = {}  # slot -> its registered (acquired) pages
    idle: list[list[int]] = []  # released chains
    log = []
    for step in range(steps):
        op = rng.integers(0, 5)
        slot = int(rng.integers(0, n_slots))
        if op == 0 and slot not in alloc.held_slots:
            got = alloc.alloc(slot, int(rng.integers(1, 6)))
            log.append(("alloc", slot, got))
        elif op == 1 and slot in alloc.held_slots and slot not in held:
            pages = list(alloc._held[slot])
            prompt = rng.integers(0, 50, len(pages) * 4).tolist()
            hashes = mod.chain_hashes(prompt, 4)
            fresh = [p for h, p in zip(hashes, pages) if cache.register(h, p)]
            alloc.transfer_out(slot, fresh)
            cache.acquire(fresh)
            held[slot] = fresh
            log.append(("register", slot, fresh, cache.lookup(hashes)))
        elif op == 2 and slot in held:
            cache.release(held[slot])
            idle.append(held.pop(slot))
            alloc.free(slot)
            log.append(("retire", slot))
        elif op == 3 and idle:
            chain = idle.pop(int(rng.integers(0, len(idle))))
            still = [p for p in chain if p in cache._hash_of]
            cache.acquire(still)
            cache.release(still)
            log.append(("touch", still))
        elif op == 4:
            log.append(("evict", cache.evict(int(rng.integers(1, 4)), alloc)))
        log.append((alloc.free_pages, sorted(alloc.held_slots.items()), cache.size))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_prefix_cache_traces_match(seed):
    assert _trace(TP, seed) == _trace(JP, seed)


@pytest.mark.parametrize("page", [1, 4, 16])
def test_chain_hashes_are_byte_equal(page):
    rng = np.random.default_rng(page)
    prompt = rng.integers(0, 128256, 70).tolist()
    ours = TP.chain_hashes(prompt, page)
    assert ours == JP.chain_hashes(prompt, page) and len(ours) == 70 // page
    assert all(isinstance(h, bytes) and len(h) == 16 for h in ours)


def test_page_helpers_match():
    for total, page in itertools.product(range(0, 70, 7), (1, 8, 16)):
        assert TP.pages_needed(total, page) == JP.pages_needed(total, page)
    for pages in ([], [3], [5, 1, 9]):
        np.testing.assert_array_equal(TP.table_row(pages, 6), JP.table_row(pages, 6))
    assert TP.TRASH_PAGE == JP.TRASH_PAGE == 0
    with pytest.raises(ValueError):
        TP.PageAllocator(1)


def test_budget_helpers_match_over_a_grid():
    grid = itertools.product((0, 100, 4224), (1, 16), (4, 8), (16, 512), (1, 8))
    for configured, batch, steps, chunk, wave in grid:
        budget = TR.token_budget(configured, batch, steps, chunk, wave)
        assert budget == JR.token_budget(configured, batch, steps, chunk, wave)
        for active, rows in itertools.product((0, 3, 16), (1, 2, 4)):
            assert TR.fits_budget(budget, active, steps, rows, chunk) == JR.fits_budget(
                budget, active, steps, rows, chunk
            )
            assert TR.wave_width_cap(budget, active, steps, chunk) == JR.wave_width_cap(
                budget, active, steps, chunk
            )


@pytest.mark.parametrize(
    "over",
    [{}, dict(page_size=16, max_seq_len=1000), dict(max_pages_per_seq=7),
     dict(num_kv_pages=40, max_batch_size=3)],
)
def test_runtime_page_counts_match(over):
    ours, ref = RuntimeConfig(**over), JaxRuntime(**over)
    assert ours.pages_per_seq() == ref.pages_per_seq()
    assert ours.pool_pages() == ref.pool_pages()
