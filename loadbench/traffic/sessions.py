"""Open-loop agent sessions, each session's turns closed.

Sessions arrive as a Poisson process at ``sessions_per_s`` and pick one of
``agents`` agent kinds by Zipf (``zipf_s``), so a few agents carry most of
the traffic.  Each agent kind has a system prompt (instructions and tool
schemas) of ``system_tokens`` tokens, the same for every session of that
kind.  Turn 1 is the system prompt plus a user message (``user_tokens``);
turn k+1 is the previous prompt, the previous turn's served output and a
tool result (``tool_tokens``), submitted ``tool_delay_ms`` after the
previous turn's last token.  Each turn asks for ``output_tokens`` new
tokens, and a session runs ``turns`` turns, ending early once a turn's
prompt and output would not fit in the deployment's sequence limit.  A
turn is timed from when it was due: its session's arrival, or its tool
delay's end.

The sizes (agents' prompt lengths, sessions' agents, turns and lengths,
arrival gaps) come from the mix's ``shape_seed`` as one base block of
``block`` sessions, each law drawn stratified, so that a block follows it
closely; the pool repeats the block.  The run's seed draws the token ids
(and the weights), never a size or an arrival, so every seed offers the
same work at the same moments.
"""

from __future__ import annotations

import asyncio
import math
from dataclasses import dataclass

import numpy as np

from loadbench.traffic import lengths, shares, strata, token_ids


@dataclass
class Plan:
    spec: dict
    seed: int
    vocab: int
    max_seq_len: int
    system: list  # [agent] → token ids
    agents: np.ndarray  # [n] agent of each session
    turns: np.ndarray  # [n]
    user: np.ndarray  # [n]
    outputs: np.ndarray  # [n, max turns]
    tools: np.ndarray  # [n, max turns]
    delays: np.ndarray  # [n, max turns] seconds
    gaps: np.ndarray  # [n] seconds before each arrival


def _block(spec: dict) -> dict:
    """The base block of session shapes, drawn from the mix's shape seed."""
    rng = np.random.default_rng(spec["shape_seed"])
    n, tmax = spec["block"], spec["turns"]["max"]
    lo, hi = spec["tool_delay_ms"]
    ranks = np.arange(1, spec["agents"] + 1, dtype=np.float64)
    zipf = ranks ** -spec["zipf_s"]
    return dict(
        system=lengths(rng, spec["system_tokens"], spec["agents"]),
        agents=shares(rng, zipf, n),
        turns=lengths(rng, spec["turns"], n),
        user=lengths(rng, spec["user_tokens"], n),
        outputs=lengths(rng, spec["output_tokens"], n * tmax).reshape(n, tmax),
        tools=lengths(rng, spec["tool_tokens"], n * tmax).reshape(n, tmax),
        delays=(lo + strata(rng, n * tmax).reshape(n, tmax) * (hi - lo)) / 1000.0,
        gaps=-np.log1p(-strata(rng, n)) / spec["sessions_per_s"],
    )


def plan(spec: dict, seed: int, vocab: int, max_seq_len: int, horizon_s: float) -> Plan:
    """The sessions that can arrive within ``horizon_s`` seconds (with room
    to spare): the base block, repeated; the seed draws the token ids."""
    base = _block(spec)
    n = spec["block"]
    blocks = max(1, math.ceil(1.25 * horizon_s * spec["sessions_per_s"] / n))
    order = np.tile(np.arange(n), blocks)
    system = [
        token_ids(seed, (1, a), int(length), vocab) for a, length in enumerate(base["system"])
    ]
    return Plan(
        spec=spec, seed=seed, vocab=vocab, max_seq_len=max_seq_len, system=system,
        agents=base["agents"][order], turns=base["turns"][order], user=base["user"][order],
        outputs=base["outputs"][order], tools=base["tools"][order],
        delays=base["delays"][order], gaps=base["gaps"][order],
    )


def context_range(plan: Plan) -> tuple[int, int]:
    """The shortest first prompt (a lone session's first decode) and the
    deployment's longest context."""
    shortest = min(len(plan.system[a]) + int(u) for a, u in zip(plan.agents, plan.user))
    return shortest, plan.max_seq_len


def prompt_range(plan: Plan) -> tuple[int, int]:
    """The shortest and the longest prompt a turn can send."""
    lo, _ = context_range(plan)
    return lo, plan.max_seq_len - 2 - int(plan.spec["output_tokens"]["min"])


async def _session(plan: Plan, i: int, arrival: float, ctx) -> None:
    agent = int(plan.agents[i])
    prompt = plan.system[agent] + token_ids(plan.seed, (2, i), int(plan.user[i]), plan.vocab)
    due = arrival
    for k in range(int(plan.turns[i])):
        want = int(plan.outputs[i, k])
        # the turn's prompt and output must fit the sequence limit (the
        # engine keeps two positions of it)
        if len(prompt) + want > plan.max_seq_len - 2 or due >= ctx.stop_at:
            return
        await ctx.sleep_until(due)
        record = await ctx.submit(prompt, want, due, f"s{i}.t{k}")
        if record.error is not None or k + 1 == int(plan.turns[i]):
            return
        tool = token_ids(plan.seed, (3, i, k), int(plan.tools[i, k]), plan.vocab)
        prompt = prompt + record.tokens + tool
        due = record.times[-1] + float(plan.delays[i, k])


async def drive(plan: Plan, ctx) -> None:
    """Start every session that arrives before ``ctx.stop_at`` at its
    arrival, and wait for all of them."""
    tasks = []
    arrival = ctx.start_at
    for i in range(len(plan.gaps)):
        arrival += float(plan.gaps[i])
        if arrival >= ctx.stop_at:
            break
        tasks.append(asyncio.ensure_future(_session(plan, i, arrival, ctx)))
    await asyncio.gather(*tasks)
