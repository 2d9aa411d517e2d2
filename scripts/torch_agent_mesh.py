#!/usr/bin/env python3
"""``chip_smoke.py``'s agent mesh phase alone, run after run, on one CUDA card.

    python3 scripts/torch_agent_mesh.py [--runs N] [--out PATH] [--device cuda|cpu]

Builds the kernels, makes the ``llama-3-8b`` preset's bf16 weights from the
engine's random init (seed 0) and runs ``chip_smoke.agent_mesh_phase`` N
times (default 3) on them: the mesh's numbers again and again, with the
client's ids seeded as the phase seeds them, so the runs differ only in
timing.  Each run's engine turns and their direct requests (the streams
the phase holds to phase 13's tie law against the bf16 plain forward) are
also held against a second witness: the plain forward in f32 on the same
weights.  For each run it prints one JSON line: per turn the dispatch
lanes, the TTFTs, the mesh's added ms (all, and for conversations alone on
their lane), the lanes' wait share and tok/s; the launches; and for each
witness the gaps between the top logit and the chosen token, counted in
bf16 spacings at the top logit's magnitude (the law allows two).  If the
phase fails, the streams it had are still held against both witnesses and
printed before the script exits with 1.  ``--device cpu`` rehearses the
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
from dataclasses import replace
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from calfkit_tpu_torch import kernels  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402

TURN_KEYS = ("lanes_occupied", "free_lane_runs", "mesh_ttft_median_ms", "mesh_ttft_max_ms",
             "engine_ttft_median_ms", "engine_ttft_max_ms", "added_median_ms", "added_max_ms",
             "free_lane_added_median_ms", "shared_lane_added_median_ms", "lane_wait_share",
             "tok_s")


def as_f32(tree):
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    return tree.float() if torch.is_tensor(tree) and tree.is_floating_point() else tree


def spacings(gaps: "list[tuple]") -> dict:
    """Gaps in bf16 spacings at the top logit's magnitude (the band is 2):
    a histogram of the rounded-up counts and the largest."""
    counts: "dict[int, int]" = {}
    largest = 0.0
    for gap, band in gaps:
        s = gap / (band / 2)
        largest = max(largest, s)
        counts[math.ceil(s)] = counts.get(math.ceil(s), 0) + 1
    return dict(counts=dict(sorted(counts.items())), largest=largest,
                over_band=sum(1 for gap, band in gaps if gap > band))


def witness(cfg, params, cases, labels, dev) -> dict:
    """Every stream of ``cases`` against the bf16 and the f32 plain forward."""
    params32, cfg32 = as_f32(params), replace(cfg, dtype="float32")
    out = {}
    for name, p, run_cfg in (("bf16", params, cfg), ("f32", params32, cfg32)):
        gaps = [g for _, prompt, *streams in cases for s in streams
                for g in chip_smoke.tie_gaps(run_cfg, p, prompt, s, dev)]
        out[name] = spacings(gaps)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return dict(streams=len(cases) * len(labels), tokens=sum(
        len(s) for _, _, *streams in cases for s in streams), **out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_agent_mesh: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    print(card)
    chip_smoke.install_tallies()
    if dev.type == "cuda":
        kernels.build_all()
    cfg = chip_smoke.preset("llama-3-8b")
    params = InferenceEngine(cfg, chip_smoke.MESH_RUNTIME, seed=0, device=dev).params
    gc.collect()
    torch.cuda.empty_cache()
    law, seen = chip_smoke.tie_law, {}

    def kept(cfg, params, cases, dev, labels=("overlapped", "lockstep")):
        seen.update(cases=cases, labels=labels)
        return law(cfg, params, cases, dev, labels)

    chip_smoke.tie_law = kept
    lines = []
    for run in range(args.runs):
        seen.clear()
        started = time.perf_counter()
        failed = None
        try:
            result = asyncio.run(chip_smoke.agent_mesh_phase(dev, params, card))
        except AssertionError as exc:
            failed = str(exc)[:2000]
        # the failed phase's engine goes with its traceback
        gc.collect()
        torch.cuda.empty_cache()
        if failed is not None:
            print(json.dumps(dict(run=run, failed=failed, witness=witness(
                cfg, params, seen["cases"], seen["labels"], dev) if seen else None)))
            return 1
        line = dict(
            run=run, seconds=time.perf_counter() - started, card=card,
            turns={t: {k: result[t][k] for k in TURN_KEYS} for t in ("turn1", "turn2")},
            tok_s=result["tok_s"], records=result["records_total"], launches=result["launches"],
            diverged=len(result["streams"]["diverged"]),
            witness=witness(cfg, params, seen["cases"], seen["labels"], dev),
        )
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
