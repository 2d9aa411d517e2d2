#!/usr/bin/env python3
"""``chip_smoke.py``'s typed-agent phase alone, run after run, on one CUDA card.

    python3 scripts/torch_typed_agent.py [--runs N] [--out PATH] [--device cuda|cpu]

Builds the kernels, makes the ``llama-3-8b`` preset's bf16 weights from the
engine's random init (seed 0) and runs phase 18
(``chip_smoke.typed_agent_phase``: a typed agent with an MCP toolbox, a
consumer and the ``/metrics`` endpoint) N times (default 1) on them,
printing one JSON line a run: the engine's TTFT of attempts 1 and 2, the
MCP ``tools/call`` round trip, the ``/metrics`` scrape, the prefix reuse of
both attempts, the typed results and faults, the launches and the round's
wall.  Every check of the phase holds or the script fails.

``--device cpu`` rehearses it on the CPU with the patches of
``scripts/torch_fleet.py`` (the debug preset, the CUDA memory calls
stubbed, the plain attention versions counted as launches; no device
metrics then).
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from calfkit_tpu_torch import kernels  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from torch_fleet import rehearse_on_the_cpu  # noqa: E402

KEYS = ("ttft_ms", "prompt_tokens", "mcp_call_ms", "decode_dispatches", "decode_dispatch_ms",
        "scrape_ms", "reuse", "typed", "faults", "launches",
        "wall_s", "engine_turns", "scraped", "measured_captures")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_typed_agent: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    if dev.type == "cpu":
        rehearse_on_the_cpu()
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    print(card)
    chip_smoke.install_tallies()
    if dev.type == "cuda":
        kernels.build_all()
    cfg = chip_smoke.preset("llama-3-8b")
    params = InferenceEngine(cfg, chip_smoke.MESH_RUNTIME, seed=0, device=dev).params
    gc.collect()
    torch.cuda.empty_cache()
    lines = []
    for run in range(args.runs):
        started = time.perf_counter()
        result = asyncio.run(chip_smoke.typed_agent_phase(dev, params, card))
        gc.collect()
        torch.cuda.empty_cache()
        line = dict(run=run, seconds=time.perf_counter() - started, card=card,
                    **{k: result[k] for k in KEYS})
        lines.append(line)
        print(json.dumps(line, default=str), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x, default=str) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
