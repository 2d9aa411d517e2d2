"""The PyTorch engine's robustness layer against ``calfkit_tpu``'s engine.

One scripted drive (``tests/_torch_port.py:robustness_drill``) runs through
both engines, built from the same f32 debug weights, under one virtual
clock that is the wall clock of both packages, in four configurations:
dense and paged + prefix cache + chunked prefill, each with overlapped and
with lockstep dispatch.  Its drills: overload with the QoS shed order,
deadline expiry of queued and active requests, the orphan reaper and the
precedence law, a stalled consumer, cancels, and the wedge watchdog.  What
must be EQUAL between the two engines: the typed error (or the full greedy
stream) of every request, every ``EngineStats`` counter, and the laws each
drill states.  The journal, metric and ledger parity of the same drives is
in ``tests/test_torch_telemetry.py``.

Also here: the landing race (an observer on the event loop that sees no
dispatch in flight must see the slot, pages and prefix references freed),
made deterministic by slowing the landing, and unit parity of the port's
``cancellation``, ``leases`` and ``qos`` copies.
"""

import asyncio
import time

import pytest

jax = pytest.importorskip("jax")

import calfkit_tpu.cancellation as JC  # noqa: E402
import calfkit_tpu.exceptions as JE  # noqa: E402
import calfkit_tpu.leases as JL  # noqa: E402
import calfkit_tpu.qos as JQ  # noqa: E402
import calfkit_tpu_torch.cancellation as PC  # noqa: E402
import calfkit_tpu_torch.exceptions as PE  # noqa: E402
import calfkit_tpu_torch.leases as PL  # noqa: E402
import calfkit_tpu_torch.qos as PQ  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, preset  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from tests._torch_port import (  # noqa: E402
    DRILL_CONFIGS,
    DRILL_PAGED,
    drills,
    jax_params,
    torch_params,
    virtual_clock,
)

TORCH_CFG = preset("debug", dtype="float32")

@pytest.fixture(scope="module")
def weights():
    p = jax_params()
    return p, torch_params(p)


@pytest.fixture(autouse=True)
def _dump_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("CALFKIT_FLIGHTREC_DIR", str(tmp_path))


# --------------------------------------------------------------------------- #
# the drills through both engines
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(DRILL_CONFIGS))
async def test_typed_error_per_request_matches_reference(weights, name):
    ref, port = await drills(weights, name)
    assert port["outcomes"] == ref["outcomes"]
    out = port["outcomes"]
    # every request ends in exactly one typed error or a full stream
    assert len(out) == 25
    # overload: batch sheds first (evicted from the queue by interactive
    # submits, or refused at submit); an interactive submit is refused only
    # when no batch request is queued
    shed = ("EngineOverloadedError", "short")
    assert [out[f"shed-{i}"][:2] for i in range(8)] == [
        shed, shed, ("ok", out["shed-2"][1]), ("ok", out["shed-3"][1]),
        ("ok", out["shed-4"][1]), shed, ("ok", out["shed-6"][1]), shed,
    ]
    assert [out[f"shed-{i}"][2:] for i in (0, 1, 5, 7)] == [(4, 4), (5, 4), (5, 4), (6, 4)]
    # deadlines: active and queued expire, the undeadlined one is served
    assert out["dl-a"] == out["dl-q"] == ("DeadlineExceededError",)
    assert out["dl-b"][0] == "ok" and len(out["dl-b"][1]) == 12
    # orphans: active and queued reaped, live lease served; deadline AND
    # lease lapsing together raise the deadline's error
    assert out["or-dead"] == out["or-dead-q"] == ("RunOrphanedError", f"{name}-dead")
    assert out["or-both"] == ("DeadlineExceededError",)
    assert out["or-live"][0] == "ok" and len(out["or-live"][1]) == 10
    assert out["st-stuck"][:2] == ("EngineOverloadedError", "delivery")
    assert out["cx-close"][0] == "ok" and len(out["cx-close"][1]) == 3
    assert out["cx-corr"][0] == "ok" and len(out["cx-corr"][1]) < 24
    assert [out[f"wg-{i}"][0] for i in (0, 1, 2)] == ["EngineWedgedError"] * 3
    assert out["wg-late"] == ("EngineWedgedError", 30.0)
    assert out["wg-after"][0] == "ok" and len(out["wg-after"][1]) == 6


@pytest.mark.parametrize("name", list(DRILL_CONFIGS))
async def test_counters_match_reference(weights, name):
    ref, port = await drills(weights, name)
    assert port["counters"] == ref["counters"]
    c = port["counters"]
    assert (c["shed_requests"], c["batch_shed"], c["interactive_shed"]) == (4, 3, 1)
    assert (c["expired_requests"], c["interactive_expired"], c["batch_expired"]) == (3, 2, 1)
    assert (c["orphaned_requests"], c["delivery_stalled"]) == (2, 1)
    assert (c["watchdog_trips"], c["watchdog_faulted"]) == (1, 4)
    assert (c["cancelled_requests"], c["cancel_propagated"]) == (2, 1)


@pytest.mark.parametrize("name", list(DRILL_CONFIGS))
async def test_survivor_streams_and_no_leak(weights, name):
    """The survivors' greedy streams equal the reference's and the lockstep
    drive's; after ``stop()`` every slot is free and every page free or
    cached."""
    ref, port = await drills(weights, name)
    served = {k: v for k, v in port["outcomes"].items() if v[0] == "ok"}
    assert served == {k: v for k, v in ref["outcomes"].items() if v[0] == "ok"}
    lockstep = (await drills(weights, name.replace("overlap", "lockstep")))[1]
    assert {k: v for k, v in lockstep["outcomes"].items() if v[0] == "ok"} == served
    assert port["free"] == [0, 1]
    if name.startswith("paged"):
        assert port["pages"] == DRILL_PAGED["num_kv_pages"] - 1
        assert port["counters"]["prefix_evictions"] > 0


# --------------------------------------------------------------------------- #
# the landing race
# --------------------------------------------------------------------------- #


def _slow_landing(engine, seconds=0.05):
    """Slow every host sync of ``engine``: the landing thread then runs
    long after the dispatch it lands, so an observer on the event loop
    polls in the middle of it."""
    sync = engine._sync_host

    def slow(staged):
        time.sleep(seconds)
        return sync(staged)

    engine._sync_host = slow


def _drained_now(engine, total_free) -> bool:
    """The no-leak law, read by an observer that sees no dispatch in
    flight: every slot, page and prefix reference is already released."""
    return (
        len(engine._free) == engine.runtime.max_batch_size
        and (total_free is None or engine._page_alloc.free_pages == total_free)
        and engine._ledger.pages_in_use == 0
    )


def _port(weights, **rt):
    base = dict(max_batch_size=1, max_seq_len=128, prefill_chunk=16,
                decode_steps_per_dispatch=4, page_size=16)
    return InferenceEngine(
        TORCH_CFG, RuntimeConfig(**{**base, **rt}), params=weights[1], device="cpu"
    )


@pytest.mark.parametrize("overlap", [True, False])
async def test_expire_parity_active_and_queued(weights, overlap):
    """The port's twin of the reference's ``TestShedExpireParity`` expire
    case, with a slow landing: once an observer sees no dispatch in flight
    and no active request, every slot and page is already free."""
    with virtual_clock() as clock:
        engine = _port(weights, kv_layout="paged", overlap_dispatch=overlap)
        _slow_landing(engine)
        total_free = engine._page_alloc.free_pages

        async def gen(prompt):
            return [t async for t in engine.generate(prompt, max_new_tokens=64,
                                                     deadline=clock.now + 5)]

        await engine.start()
        try:
            active = asyncio.create_task(gen([1, 2]))
            for _ in range(400):
                if engine._active:
                    break
                await asyncio.sleep(0.005)
            queued = asyncio.create_task(gen([3, 4]))
            for _ in range(400):
                if len(engine._pending) + len(engine._carry) == 1:
                    break
                await asyncio.sleep(0.005)
            clock.advance(10)
            with pytest.raises(PE.DeadlineExceededError):
                await active
            with pytest.raises(PE.DeadlineExceededError):
                await queued
            for _ in range(400):
                if not engine._active and engine._pend is None:
                    break
                await asyncio.sleep(0.001)
            assert not engine._active and engine._pend is None
            assert _drained_now(engine, total_free), (
                f"free list has {len(engine._free)} of 1 slots, "
                f"{engine._page_alloc.free_pages} of {total_free} pages"
            )
            assert engine.stats.expired_requests == 2
            assert engine.stats.cancelled_requests == 0
            assert len([t async for t in engine.generate([9], max_new_tokens=8)]) == 8
        finally:
            await engine.stop()


@pytest.mark.parametrize("overlap", [True, False])
async def test_cancel_mid_flight_frees_before_the_pend_clears(weights, overlap):
    """The port's twin of the reference's cancel-mid-flight test, with a
    slow landing: a consumer that closes its stream with a dispatch in
    flight gets nothing after the reap, and an observer that sees no
    dispatch in flight sees the slot and pages freed, exactly once."""
    engine = _port(weights, kv_layout="paged", overlap_dispatch=overlap)
    _slow_landing(engine)
    total_free = engine._page_alloc.free_pages
    frees = []
    free = engine._page_alloc.free

    def counting_free(slot):
        frees.append(slot)
        return free(slot)

    engine._page_alloc.free = counting_free
    await engine.start()
    try:
        agen = engine.generate([1, 2, 3], max_new_tokens=64)
        got = []
        async for token in agen:
            got.append(token)
            if len(got) >= 2:
                break
        request = next(iter(engine._active.values()))
        await agen.aclose()
        for _ in range(400):
            if engine._pend is None and not engine._active:
                break
            await asyncio.sleep(0.001)
        assert engine._pend is None and not engine._active
        assert _drained_now(engine, total_free), (
            f"free list has {len(engine._free)} of 1 slots"
        )
        assert frees == [0]
        while not request.out.empty():
            request.out.get_nowait()
        for _ in range(10):
            await asyncio.sleep(0.005)
        assert request.out.empty(), "delivery to a cancelled consumer after the reap"
        assert len([t async for t in engine.generate([4, 5], max_new_tokens=4)]) == 4
    finally:
        await engine.stop()


# --------------------------------------------------------------------------- #
# unit parity of the copied modules
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("value", [None, "interactive", "batch", "BATCH", "", "gold", 3])
def test_priority_resolution_matches_reference(value):
    assert PQ.resolve_priority(value) == JQ.resolve_priority(value)
    assert PQ.class_rank(value) == JQ.class_rank(value)
    assert (PQ.PRIORITY_CLASSES, PQ.DEFAULT_PRIORITY) == (
        JQ.PRIORITY_CLASSES, JQ.DEFAULT_PRIORITY
    )
    token = PQ.current_priority.set(value)
    jtoken = JQ.current_priority.set(value)
    try:
        assert PQ.resolve_priority() == JQ.resolve_priority()
    finally:
        PQ.current_priority.reset(token)
        JQ.current_priority.reset(jtoken)


def test_lease_law_matches_reference():
    """Beats, admission stamps, expiry, age, lapse, release and the liveness
    fold under one virtual clock: the same answers from both stores."""
    with virtual_clock() as clock:
        answers = {}
        for pkg, leases in (("jax", JL), ("port", PL)):
            out = []
            t0 = clock.now
            leases.note_beat("u-a", 5.0)
            leases.note_admission("u-b", 2.0)
            out.append((leases.lease_expiry("u-a") - t0, leases.lease_age("u-a"),
                        leases.lease_lapsed("u-a"), leases.lease_lapsed("u-never"),
                        leases.lease_expiry("u-never"), leases.lease_age(None)))
            clock.advance(3.0)
            out.append((leases.lease_lapsed("u-a"), leases.lease_lapsed("u-b"),
                        leases.lease_age("u-b")))
            leases.note_admission("u-b", 2.0)  # lapsed: no resurrection
            leases.note_beat("u-a", 5.0, at=t0)  # a stale beat never ages it backward
            out.append((leases.lease_lapsed("u-b"), leases.lease_expiry("u-a") - t0))
            gen = leases.release_generation()
            leases.release_lease("u-a")
            leases.note_beat("u-a", 5.0)  # released is terminal
            out.append((leases.lease_lapsed("u-a"), leases.release_generation() - gen))
            leases.fold_liveness_record(b"u-c", leases.beat_payload("u-c", 4.0))
            leases.fold_liveness_record("u-d", b"not json")
            leases.fold_liveness_record(b"u-c2", b"")
            out.append((leases.lease_expiry("u-c") - clock.now, leases.lease_expiry("u-d"),
                        leases.lease_lapsed("u-c2")))
            clock.advance(-3.0)
            answers[pkg] = out
        assert answers["port"] == answers["jax"]
        assert answers["port"][0][:3] == (5.0, 0.0, False)


def test_cancellation_plumbing_matches_reference():
    """Tombstones live their TTL on the wall-clock seam; a cancel fans out
    to every registered target and records the tombstone."""

    class Target:
        def __init__(self):
            self.seen = []

        def cancel_correlation(self, corr):
            self.seen.append(corr)
            return 2

    with virtual_clock() as clock:
        answers = {}
        for pkg, canc in (("jax", JC), ("port", PC)):
            target = Target()
            canc.register_cancel_target(target)
            n = canc.propagate_cancel("u-corr")
            out = [n >= 2, target.seen, canc.was_cancelled("u-corr"),
                   canc.was_cancelled("u-other"), canc.was_cancelled(None),
                   canc.propagate_cancel("")]
            clock.advance(601.0)
            out.append(canc.was_cancelled("u-corr"))
            clock.advance(-601.0)
            answers[pkg] = out
            assert canc.current_deadline.get() is None
        assert answers["port"] == answers["jax"] == [
            True, ["u-corr"], True, False, False, 0, False
        ]


@pytest.mark.parametrize("name", ["EngineOverloadedError", "EngineWedgedError",
                                  "DeadlineExceededError", "RunOrphanedError",
                                  "InferenceError"])
def test_typed_errors_carry_the_reference_codes(name):
    from calfkit_tpu.exceptions import RETRIABLE_FAULT_TYPES, error_type_for

    ref = getattr(JE, name)("x")
    port = getattr(PE, name)("x")
    assert port.code == error_type_for(ref)
    assert port.retriable == (port.code in RETRIABLE_FAULT_TYPES)
    assert isinstance(port, TimeoutError) == isinstance(ref, TimeoutError)
    for field in ("lane", "pending", "limit", "stalled_s", "lease_id", "lapsed_s"):
        assert hasattr(port, field) == hasattr(ref, field)

