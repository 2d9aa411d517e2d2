"""A closed loop of ``clients`` clients with unshared prompts.

Each client submits its next request as soon as its previous one ends, so
the batch stays full.  Prompts are ``prompt_tokens`` long, distinct token
ids drawn from the run's seed; each request asks for ``output_tokens`` new
tokens.  Clients start evenly over ``stagger_s`` seconds, so their
completions do not come in lockstep.  A request is timed from its
submission.

The sizes come from the mix's ``shape_seed`` as a base block of ``block``
requests, each law drawn stratified, taken in order and repeated.  The
run's seed draws the token ids (and the weights), never a size, so every
seed offers the same work.
"""

from __future__ import annotations

import asyncio
import itertools
from dataclasses import dataclass

import numpy as np

from loadbench.traffic import lengths, token_ids


@dataclass
class Plan:
    spec: dict
    seed: int
    vocab: int
    max_seq_len: int
    prompts: np.ndarray  # [block] base prompt lengths
    outputs: np.ndarray  # [block] base output lengths

    def sizes(self, j: int) -> tuple[int, int]:
        """Request ``j``'s (prompt, output) lengths."""
        r = j % len(self.prompts)
        return int(self.prompts[r]), int(self.outputs[r])


def plan(spec: dict, seed: int, vocab: int, max_seq_len: int, horizon_s: float) -> Plan:
    rng = np.random.default_rng(spec["shape_seed"])
    n = spec["block"]
    prompts = lengths(rng, spec["prompt_tokens"], n)
    outputs = lengths(rng, spec["output_tokens"], n)
    if int((prompts + outputs).max()) > max_seq_len - 2:
        raise ValueError("a request of the mix does not fit the sequence limit")
    return Plan(spec, seed, vocab, max_seq_len, prompts, outputs)


def context_range(plan: Plan) -> tuple[int, int]:
    """The least and the most that the longest of ``clients`` active
    requests holds: the least over many draws of ``clients`` requests at
    random points of their outputs (the shape seed's draws), and the
    longest request."""
    rng = np.random.default_rng([plan.spec["shape_seed"], 9])
    n, clients = len(plan.prompts), plan.spec["clients"]
    picks = rng.integers(0, n, size=(2000, clients))
    progress = rng.uniform(0.0, 1.0, size=(2000, clients))
    held = plan.prompts[picks] + np.floor(progress * plan.outputs[picks])
    return int(held.max(axis=1).min()), int((plan.prompts + plan.outputs).max())


def prompt_range(plan: Plan) -> tuple[int, int]:
    return int(plan.prompts.min()), int(plan.prompts.max())


async def _client(plan: Plan, c: int, counter, ctx) -> None:
    clients = plan.spec["clients"]
    await ctx.sleep_until(ctx.start_at + plan.spec["stagger_s"] * c / clients)
    while True:
        due = ctx.now()
        if due >= ctx.stop_at:
            return
        j = next(counter)
        prompt_len, want = plan.sizes(j)
        prompt = token_ids(plan.seed, (4, j), prompt_len, plan.vocab)
        record = await ctx.submit(prompt, want, due, f"c{c}.r{j}")
        if record.error is not None:
            return


async def drive(plan: Plan, ctx) -> None:
    counter = itertools.count()
    await asyncio.gather(*(_client(plan, c, counter, ctx) for c in range(plan.spec["clients"])))
