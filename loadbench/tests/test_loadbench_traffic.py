"""The traffic generators: determined by the seed, the same work for every
seed, and drawn as their files say."""

from __future__ import annotations

import asyncio
import statistics

import numpy as np
import pytest

from loadbench import drive, traffic

SEEDS = (3, 2**31 + 7, 123456789012)


def _sessions(seed, horizon=60.0, rate=None):
    spec = traffic.load("agent-loop")
    if rate is not None:
        spec = dict(spec, sessions_per_s=rate)
    gen = traffic.generator("sessions")
    return spec, gen, gen.plan(spec, seed, 32768, 8192, horizon)


@pytest.mark.parametrize("seed", SEEDS)
def test_sessions_are_determined_by_the_seed(seed):
    _, _, a = _sessions(seed)
    _, _, b = _sessions(seed)
    assert a.system == b.system
    for field in ("agents", "turns", "user", "outputs", "tools", "delays", "gaps"):
        assert np.array_equal(getattr(a, field), getattr(b, field))
    _, _, c = _sessions(seed + 1)
    assert a.system != c.system


def test_sessions_offer_the_same_work_for_every_seed():
    plans = [_sessions(seed)[2] for seed in SEEDS]
    for field in ("agents", "turns", "user", "outputs", "tools", "delays", "gaps"):
        assert all(np.array_equal(getattr(p, field), getattr(plans[0], field)) for p in plans)
    assert [len(s) for s in plans[0].system] == [len(s) for s in plans[1].system]
    assert plans[0].system != plans[1].system


def test_sessions_follow_the_file():
    spec, gen, plan = _sessions(5, horizon=400.0, rate=3.0)
    lens = [len(s) for s in plan.system]
    assert len(lens) == spec["agents"] and all(2048 <= n <= 3072 for n in lens)
    counts = np.bincount(plan.agents, minlength=spec["agents"]) / len(plan.agents)
    zipf = 1.0 / np.arange(1, 9)
    assert np.allclose(counts, zipf / zipf.sum(), atol=0.05)
    assert plan.turns.min() >= 2 and plan.turns.max() <= 6
    assert plan.user.min() >= 64 and plan.user.max() <= 256
    assert abs(statistics.median(plan.outputs.ravel().tolist()) - 64) <= 6
    assert plan.outputs.min() >= 16 and plan.outputs.max() <= 256
    assert abs(statistics.median(plan.tools.ravel().tolist()) - 256) <= 25
    assert plan.tools.min() >= 64 and plan.tools.max() <= 1024
    assert 0.05 <= plan.delays.min() and plan.delays.max() <= 0.25
    assert abs(1.0 / plan.gaps.mean() - spec["sessions_per_s"]) < 0.15 * spec["sessions_per_s"]
    lo, hi = gen.context_range(plan)
    assert 2048 + 64 <= lo <= 3072 + 256 and hi == 8192


def test_closed_loop_is_determined_and_follows_the_file():
    spec = traffic.load("chat-batch")
    gen = traffic.generator("closed")
    plans = [gen.plan(spec, seed, 32768, 8192, 60.0) for seed in SEEDS]
    a = [plans[0].sizes(j) for j in range(spec["block"])]
    b = [plans[1].sizes(j) for j in range(spec["block"])]
    assert a == b == [plans[0].sizes(j + spec["block"]) for j in range(spec["block"])]
    prompts = [p for p, _ in a]
    assert min(prompts) >= 64 and max(prompts) <= 1024
    assert abs(statistics.median(prompts) - 256) <= 30
    assert all(96 <= o <= 160 for _, o in a)
    lo, hi = gen.context_range(plans[0])
    assert lo < hi <= 1024 + 160


class _Echo:
    """An engine stand-in that serves ``max_new_tokens`` tokens at once."""

    async def generate(self, prompt, max_new_tokens):
        for i in range(max_new_tokens):
            yield i


def _run(gen, plan, seconds):
    async def go():
        ctx = drive.Context(_Echo(), drive.Context.now(), drive.Context.now() + seconds)
        await gen.drive(plan, ctx)
        return ctx.records
    return asyncio.run(go())


def test_sessions_resend_their_history_and_stop_at_the_window():
    spec, gen, plan = _sessions(11, horizon=2.0, rate=20.0)
    records = _run(gen, plan, 1.0)
    assert records and all(r.complete for r in records)
    by_session = {}
    for r in records:
        by_session.setdefault(r.tag.split(".")[0], []).append(r)
    for turns in by_session.values():
        for prev, nxt in zip(turns, turns[1:]):
            assert nxt.prompt[: len(prev.prompt) + len(prev.tokens)] == prev.prompt + prev.tokens
            assert nxt.due >= prev.times[-1] + 0.05 - 1e-6
    assert all(len(r.prompt) + r.max_new <= 8190 for r in records)


def test_closed_clients_send_distinct_prompts():
    spec = traffic.load("chat-batch")
    gen = traffic.generator("closed")
    plan = gen.plan(dict(spec, stagger_s=0.01), 9, 32768, 8192, 1.0)
    records = _run(gen, plan, 0.3)
    prompts = {tuple(r.prompt[:16]) for r in records}
    assert len(records) > spec["clients"] and len(prompts) == len(records)
