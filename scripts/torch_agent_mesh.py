#!/usr/bin/env python3
"""``chip_smoke.py``'s agent mesh phases alone, run after run, on one CUDA card.

    python3 scripts/torch_agent_mesh.py [--mesh memory,kafka,tcp] [--runs N] [--out PATH]
                                        [--device cuda|cpu]

Builds the kernels (and, for a wire transport, the native brokers and CRC
library), makes the ``llama-3-8b`` preset's bf16 weights from the engine's
random init (seed 0) and runs, N times (default 3) on them, each mesh of
``--mesh`` in turn (default ``memory``): ``memory`` is
``chip_smoke.agent_mesh_phase`` (phase 15, the ``InMemoryMesh``),
``kafka`` and ``tcp`` are ``chip_smoke.wire_mesh_phase`` (phase 16: the
Client in another process over ``kafkad`` or ``meshd``; its excess over
the in-memory figures is taken against the same run's ``memory`` phase
when ``memory`` comes first in ``--mesh``).  The mesh's numbers again and
again, with the client's ids seeded as the phases seed them, so the runs
differ only in timing.  Each run's engine turns and their direct requests
(the streams the phase holds to phase 13's tie law against the f32 plain
forward) are also held against a second witness: the plain forward in bf16,
the law's witness until the band was set (band 2).  For each run and mesh it
prints one JSON line: per
turn the dispatch lanes, the TTFTs, the mesh's added ms (all, and for
conversations alone on their lane), the lanes' wait share and tok/s (for a
wire transport also the added ms over the in-memory phase, the boot
seconds and the seconds to the first assignment; for ``memory`` also the
phase's fallback step: both turns' TTFT and execute ms, the loopback's
requests, the step's launches, graph keys and seconds); the launches; and for
each witness the gaps between the top logit and the chosen token, counted in
bf16 spacings at the top logit's magnitude, and every token past the band
of either witness with its gap under both and under the bf16 plain forward
run on the engine's schedule (the prompt in the runtime's prefill chunks,
then one token a step).  After the first phase it prints one line of the
law's controls on that phase's engine-turn prompts: the bf16
plain forward's own greedy streams with its K/V as they are (7 mantissa
bits, a sound bf16 computation) and rounded to 6, 5 and 3 bits (lower
precision), each against the f32 witness, in spacings beside the law's band
(``chip_smoke.TIE_SPACINGS``).  A phase that fails is
reported with the streams it had against the witnesses, the runs go on,
and the script exits with 1 at the end.  ``--device cpu`` rehearses the
script on the CPU (with ``chip_smoke.preset`` patched to a small preset;
no device metrics then).
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from calfkit_tpu_torch import kernels  # noqa: E402
from calfkit_tpu_torch.inference import model as M  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from calfkit_tpu_torch.mesh import _native  # noqa: E402

TURN_KEYS = ("lanes_occupied", "free_lane_runs", "mesh_ttft_median_ms", "mesh_ttft_max_ms",
             "engine_ttft_median_ms", "engine_ttft_max_ms", "added_median_ms", "added_max_ms",
             "free_lane_added_median_ms", "shared_lane_added_median_ms", "lane_wait_share",
             "tok_s")


def spacings(gaps: "list[tuple]", band: float) -> dict:
    """(gap, one bf16 spacing) pairs → a histogram of the gaps in spacings,
    rounded up, the largest, and how many lie past ``band`` spacings."""
    counts: "dict[int, int]" = {}
    largest, over = 0.0, 0
    for gap, spacing in gaps:
        s = gap / spacing
        largest = max(largest, s)
        over += s > band
        counts[math.ceil(s)] = counts.get(math.ceil(s), 0) + 1
    return dict(counts=dict(sorted(counts.items())), largest=largest, over_band=over)


def scheduled_gaps(cfg, params, prompt, stream, chunk: int, dev) -> "list[tuple]":
    """:func:`chip_smoke.tie_gaps` with the engine's schedule: the plain
    forward over ``prompt`` in chunks of ``chunk`` positions from 0 (the
    engine's prefill chunks, and the page-aligned prefix it reuses), then
    ``stream`` one token a step, as the engine decodes → (gap, spacing)."""
    seq = prompt + stream
    n = len(seq)
    cache = M.make_empty_cache(cfg, 1, n, device=dev)

    def run(a: int, b: int) -> torch.Tensor:
        logits, _ = M.forward(
            params, cfg, torch.tensor([seq[a:b]], dtype=torch.int32, device=dev),
            torch.arange(a, b, dtype=torch.int32, device=dev)[None], cache,
            torch.tensor([b], dtype=torch.int32, device=dev), attn_impl="plain")
        return logits[0, -1].float()

    bounds = [*range(0, len(prompt), chunk), len(prompt)]
    rows = [run(a, b) for a, b in zip(bounds, bounds[1:])][-1:]
    rows += [run(t, t + 1) for t in range(len(prompt), n - 1)]
    lg = torch.stack(rows)
    top = lg.max(dim=1).values
    chosen = lg.gather(1, torch.tensor(stream, device=dev)[:, None])[:, 0]
    spacing = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(2.0 ** -126))) - 7)
    return list(zip((top - chosen).tolist(), spacing.tolist()))


def witness(cfg, params, cases, labels, dev, chunk: int) -> dict:
    """Every stream of ``cases`` against the f32 plain forward (the law's
    witness, :func:`chip_smoke.witness_gaps`, band ``chip_smoke.TIE_SPACINGS``)
    and the bf16 plain forward (the law's witness until PR 13's review,
    band 2); each token past either band, with its gap in bf16 spacings
    under both and under the bf16 plain forward on the engine's schedule
    (:func:`scheduled_gaps`)."""
    streams = [(name, label, prompt, s) for name, prompt, *runs in cases
               for label, s in zip(labels, runs)]
    gaps = {"f32": [chip_smoke.witness_gaps(cfg, params, prompt, [s], dev)[0]
                    for _, _, prompt, s in streams],
            "bf16": [[(g, band / 2) for g, band in chip_smoke.tie_gaps(cfg, params, prompt, s, dev)]
                     for _, _, prompt, s in streams]}
    bands = {"f32": chip_smoke.TIE_SPACINGS, "bf16": 2}
    out = {w: spacings([g for stream in gaps[w] for g in stream], bands[w]) for w in gaps}
    past = []
    for i, (name, label, prompt, s) in enumerate(streams):
        steps = [t for t in range(len(s))
                 if any(gaps[w][i][t][0] > bands[w] * gaps[w][i][t][1] for w in gaps)]
        if steps:
            scheduled = scheduled_gaps(cfg, params, prompt, s, chunk, dev)
            past += [dict(stream=name, run=label, step=t, prompt_tokens=len(prompt), **{
                w: g[t][0] / g[t][1] for w, g in (
                    ("bf16", gaps["bf16"][i]), ("f32", gaps["f32"][i]),
                    ("bf16_scheduled", scheduled))}) for t in steps]
    return dict(streams=len(streams), tokens=sum(len(s) for *_, s in streams),
                past_band=past, **out)


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """bf16 ``x`` rounded to ``bits`` mantissa bits (bf16 has 7), to
    nearest, ties away from zero, the exponent's range kept."""
    if bits >= 7:
        return x
    drop = 7 - bits
    u = x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    u = (u + (1 << (drop - 1))) & (0xFFFF ^ ((1 << drop) - 1))
    return torch.where(u >= 0x8000, u - 0x10000, u).to(torch.int16).view(torch.bfloat16)


def greedy(cfg, params, prompt: "list[int]", n: int, bits: int, dev) -> "list[int]":
    """The bf16 plain forward's own greedy continuation of ``prompt``, ``n``
    tokens (the prompt in one pass, then a token a step), every K/V it
    writes to its cache rounded to ``bits`` mantissa bits (7: as it is)."""
    insert = M._insert_chunk
    M._insert_chunk = lambda pages, x, at: insert(pages, round_mantissa(x, bits), at)
    try:
        cache = M.make_empty_cache(cfg, 1, len(prompt) + n, device=dev)
        seq, at = list(prompt), 0
        while len(seq) < len(prompt) + n:
            logits, _ = M.forward(
                params, cfg, torch.tensor([seq[at:]], dtype=torch.int32, device=dev),
                torch.arange(at, len(seq), dtype=torch.int32, device=dev)[None], cache,
                torch.tensor([len(seq)], dtype=torch.int32, device=dev), attn_impl="plain")
            at = len(seq)
            seq.append(int(logits[0, -1].float().argmax()))
    finally:
        M._insert_chunk = insert
    return seq[len(prompt):]


CONTROL_BITS = (7, 6, 5, 3)  # 7: bf16 as it is, the sound control


def controls(cfg, params, cases, dev) -> dict:
    """The law's controls on ``cases``' prompts: for each mantissa width of
    :data:`CONTROL_BITS`, the bf16 plain forward's own greedy streams (as
    long as the cases' first streams) with its K/V rounded to that width,
    against the f32 witness → the gaps in spacings, as :func:`spacings`
    gives them against ``chip_smoke.TIE_SPACINGS``."""
    out = {}
    for bits in CONTROL_BITS:
        gaps = []
        for _, prompt, stream, *_ in cases:
            own = greedy(cfg, params, prompt, len(stream), bits, dev)
            gaps += chip_smoke.witness_gaps(cfg, params, prompt, [own], dev)[0]
        out[f"mantissa_{bits}"] = spacings(gaps, chip_smoke.TIE_SPACINGS)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--out")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--mesh", default="memory",
                        help="comma-separated meshes run in turn each run: memory, kafka, tcp")
    args = parser.parse_args()
    meshes = args.mesh.split(",")
    if not set(meshes) <= {"memory", "kafka", "tcp"}:
        parser.error(f"unknown mesh in {args.mesh!r}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_agent_mesh: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    print(card)
    chip_smoke.install_tallies()
    if dev.type == "cuda":
        kernels.build_all()
    if set(meshes) & {"kafka", "tcp"}:
        _native.use_native_builds(_native.build_native())
    cfg = chip_smoke.preset("llama-3-8b")
    params = InferenceEngine(cfg, chip_smoke.MESH_RUNTIME, seed=0, device=dev).params
    gc.collect()
    torch.cuda.empty_cache()
    law, seen = chip_smoke.tie_law, {}

    def kept(cfg, params, cases, dev, labels=("overlapped", "lockstep")):
        # the phase's own law over its 16 turns, not its fallback step's
        if "cases" not in seen:
            seen.update(cases=cases, labels=labels)
        return law(cfg, params, cases, dev, labels)

    chip_smoke.tie_law = kept
    chunk = chip_smoke.MESH_RUNTIME.prefill_chunk
    lines, failures = [], 0
    for run in range(args.runs):
        in_memory = None
        for mesh in meshes:
            seen.clear()
            started = time.perf_counter()
            failed = None
            try:
                if mesh == "memory":
                    result = asyncio.run(chip_smoke.agent_mesh_phase(dev, params, card))
                    in_memory = result
                else:
                    result = asyncio.run(
                        chip_smoke.wire_mesh_phase(dev, params, mesh, in_memory, card))
            except AssertionError as exc:
                failed = str(exc)[:2000]
            # the failed phase's engine goes with its traceback
            gc.collect()
            torch.cuda.empty_cache()
            line = dict(run=run, mesh=mesh, seconds=time.perf_counter() - started, card=card)
            if failed is not None:
                # the streams the phase had, against the witnesses; the runs go on
                failures += 1
                line.update(failed=failed)
            else:
                line.update(
                    turns={t: {k: result[t][k] for k in TURN_KEYS} for t in ("turn1", "turn2")},
                    tok_s=result["tok_s"], records=result["records_total"],
                    launches=result["launches"], diverged=len(result["streams"]["diverged"]))
                if mesh == "memory":
                    line.update(fallback={k: v for k, v in result["fallback"].items()
                                          if k not in ("note", "law")})
                else:
                    line.update(over_in_memory=result["over_in_memory"],
                                boot_s=result["boot_s"],
                                first_assignment_s=result["first_assignment_s"])
            if seen:
                line.update(witness=witness(cfg, params, seen["cases"], seen["labels"], dev,
                                            chunk))
            lines.append(line)
            print(json.dumps(line), flush=True)
            if seen and not any("controls" in x for x in lines):
                started = time.perf_counter()
                line = dict(controls=controls(cfg, params, seen["cases"], dev), mesh=mesh,
                            prompts=len(seen["cases"]), band=chip_smoke.TIE_SPACINGS,
                            seconds=time.perf_counter() - started, card=card)
                lines.append(line)
                print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
