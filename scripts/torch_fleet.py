#!/usr/bin/env python3
"""``chip_smoke.py``'s serving-fleet phase alone, run after run, on one CUDA card.

    python3 scripts/torch_fleet.py [--runs N] [--out PATH] [--device cuda|cpu]

Builds the kernels, makes the ``llama-3-8b`` preset's bf16 weights from the
engine's random init (seed 0), runs phase 15 (``chip_smoke.agent_mesh_phase``,
one engine) once, then phase 17 (``chip_smoke.fleet_phase``: two replicas
behind the fleet router, a kill mid-stream, a drain) N times (default 1) on
the same weights, and prints one JSON line a phase: per turn the TTFT
through the mesh or the fleet, the engine's own and the added ms; tok/s;
the launches; for phase 17 also each replica's placements, prefix reuse,
captures and launches, the kill drive's numbers (the seconds from the kill
to the first resumed token, the resumed offset, the survivor's decode and
prefill tokens, the failovers), the drain's and the memory's.  Every check
of the phases holds or the script fails.

``--device cpu`` rehearses it on the CPU: ``chip_smoke.preset`` gives the
debug preset, the CUDA memory calls are stubbed, the plain attention
versions count as launches, and each replica's dispatch is slowed by 10 ms
so the kill lands mid-stream (no device metrics then).
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

import chip_smoke  # noqa: E402
from calfkit_tpu_torch import kernels  # noqa: E402
from calfkit_tpu_torch.inference import attention as A  # noqa: E402
from calfkit_tpu_torch.inference.config import preset  # noqa: E402
from calfkit_tpu_torch.inference.engine import InferenceEngine  # noqa: E402

TURN_KEYS = ("mesh_ttft_median_ms", "mesh_ttft_max_ms", "engine_ttft_median_ms",
             "engine_ttft_max_ms", "added_median_ms", "added_max_ms", "lane_wait_share", "tok_s")


def rehearse_on_the_cpu() -> None:
    """The patches of a CPU rehearsal (see the module's docstring)."""
    for name in ("synchronize", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        setattr(torch.cuda, name, lambda *a, **k: 0)
    chip_smoke.preset = lambda name: preset("debug")
    for name in ("paged_decode_attention", "prefill_attention"):
        plain = getattr(A, name + "_reference")

        def counted(*args, _plain=plain, _name=name, **kw):
            A.launch_counts[_name] += 1
            return _plain(*args, **kw)

        setattr(A, name + "_reference", counted)
    init = chip_smoke.ReplicaEngine.__init__

    def paced(self, *args, **kw):
        init(self, *args, **kw)
        self._chaos = lambda point: time.sleep(0.01) if point == "dispatch" else None

    chip_smoke.ReplicaEngine.__init__ = paced


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_fleet: no CUDA device", file=sys.stderr)
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
    started = time.perf_counter()
    mesh = asyncio.run(chip_smoke.agent_mesh_phase(dev, params, card))
    lines.append(dict(phase=15, seconds=time.perf_counter() - started, card=card,
                      turns={t: {k: mesh[t][k] for k in TURN_KEYS} for t in ("turn1", "turn2")},
                      tok_s=mesh["tok_s"], launches=mesh["launches"]))
    print(json.dumps(lines[-1]), flush=True)
    for run in range(args.runs):
        gc.collect()
        torch.cuda.empty_cache()
        started = time.perf_counter()
        fleet = asyncio.run(chip_smoke.fleet_phase(dev, params, mesh, card))
        lines.append(dict(
            phase=17, run=run, seconds=time.perf_counter() - started, card=card,
            turns={t: {k: fleet[t][k] for k in TURN_KEYS} for t in ("turn1", "turn2")},
            tok_s=fleet["tok_s"], launches=fleet["launches"],
            replicas={tag: {k: v for k, v in r.items() if k != "graphs"}
                      for tag, r in fleet["replicas"].items()},
            kill=fleet["kill"], drain=fleet["drain"], memory=fleet["memory"],
            max_gap=fleet["streams"]["max_gap"], kill_max_gap=fleet["kill_law"]["max_gap"],
            diverged=len(fleet["streams"]["diverged"])))
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
