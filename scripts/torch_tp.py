#!/usr/bin/env python3
"""``chip_smoke.py``'s tensor-parallel phase alone, on one CUDA card.

    python3 scripts/torch_tp.py [--runs N] [--out PATH] [--device cuda|cpu]
                                [--nccl-layers L [--long]]

Builds the kernels and runs phase 19 (``chip_smoke.tp_phase``: llama-3-8b
bf16 at ``RuntimeConfig(tp=2)`` in two processes sharing the card over
gloo, phase 15's agent round and then the sp step, a 6,000-token prompt
through the long lane sharded over both ranks, under ``graphs.eager()``)
N times (default 1), printing one JSON line a run: tok/s, TTFT, the
descriptors' host ms, the gloo collectives' ms, each rank's launches and
peak allocation, each rank's #5 and #2 against their plain versions, the
tie law's gaps, the sp step's numbers (``long``: TTFT, prefill seconds,
decode tok/s, collectives, launches and scratch by rank, #1 and #3 against
their plain versions at each rank's block) and the phase's seconds.  Every
check of the phase holds or the script fails.

``--nccl-layers L`` (two or more cards) runs only the phase's drive over
NCCL on CUDA graphs (``chip_smoke.tp_nccl_drive``), one card a rank, on
llama-3-8b's widths cut to L layers; ``--long`` adds the sp step to it
(the ring's point-to-point hops and the merges captured in the graphs).

``--device cpu`` rehearses it on the CPU with the patches of
``scripts/torch_fleet.py`` (rank 0 only: rank 1, a spawned process, runs
unpatched, so its launch counts stay 0 and the phase's launch checks
fail there by design).
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

KEYS = ("tok_s", "output_tokens", "wall_s", "descriptors", "descriptor_ms", "collectives",
        "collective_ms", "launches", "peak", "rank_cases", "streams", "long", "seconds", "nccl")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--out")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nccl-layers", type=int,
                        help="run only the NCCL drive, at llama-3-8b cut to this depth")
    parser.add_argument("--long", action="store_true",
                        help="with --nccl-layers: add the sp step to the NCCL drive")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_tp: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    if dev.type == "cpu":
        from torch_fleet import rehearse_on_the_cpu

        rehearse_on_the_cpu()
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    print(card)
    chip_smoke.install_tallies()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.build_all()
    lines = []
    for run in range(args.runs):
        started = time.perf_counter()
        if args.nccl_layers:
            cfg = chip_smoke.preset("llama-3-8b", n_layers=args.nccl_layers)
            generator = torch.Generator(device=dev)
            generator.manual_seed(chip_smoke.TP_SEED)
            params = chip_smoke.M.init_params(cfg, generator)
            result = asyncio.run(chip_smoke.tp_nccl_drive(dev, cfg, params, card, args.long))
            del params
            keys = [k for k in KEYS if k in result]
        else:
            result = asyncio.run(chip_smoke.tp_phase(dev, None, card))
            keys = KEYS
        gc.collect()
        torch.cuda.empty_cache()
        line = dict(run=run, seconds_run=time.perf_counter() - started, card=card,
                    **{k: result[k] for k in keys})
        lines.append(line)
        print(json.dumps(line, default=str), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x, default=str) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
