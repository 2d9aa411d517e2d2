"""A tiny cell for the CPU tests: a copy of the benchmark's folder under a
temporary root, with a debug-sized configuration, two tiny traffic mixes
and their limits added as files, as a later change would add them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from loadbench import manifest

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, vocab_size=512,
)
TINY_RUNTIME = dict(
    page_size=8, prefill_chunk=16, max_seq_len=256, max_batch_size=8, num_kv_pages=400,
    max_prefill_wave=4,
)
TINY_TRAFFIC = {
    "agent-loop": dict(
        sessions_per_s=6.0, system_tokens={"min": 40, "max": 70}, user_tokens={"min": 4, "max": 12},
        tool_tokens={"median": 10, "sigma": 0.5, "min": 4, "max": 30},
        output_tokens={"median": 6, "sigma": 0.4, "min": 3, "max": 12},
        ramp_s=0.5, block=16, check_tokens=40, check_requests=4,
    ),
    "chat-batch": dict(
        clients=6, prompt_tokens={"median": 20, "sigma": 0.6, "min": 6, "max": 60},
        output_tokens={"min": 4, "max": 10}, stagger_s=0.2, ramp_s=0.5, block=32,
        check_tokens=40, check_requests=4,
    ),
}
LIMIT = 0.01  # sound runs of the tiny models read at most 0.0006 on the CPU, int4 0.14-0.35


def make_root(tmp_path: Path, traffic: str = "agent-loop", quantization: "str | None" = None,
              limit: float = LIMIT) -> "tuple[Path, dict, dict]":
    """A root under ``tmp_path`` holding ``BENCHMARK.json`` and a copy of
    ``loadbench/`` with the tiny cell ``tiny.<traffic>`` added →
    (root, manifest, cell).  Point ``manifest.BENCH_DIR`` at
    ``root / "loadbench"`` to run it."""
    root = tmp_path / "root"
    bench_dir = root / "loadbench"
    shutil.copytree(REPO / "loadbench", bench_dir, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    base = "mistral-7b-v0.3-w8" if quantization == "int8" else "mistral-7b-v0.3"
    config = json.loads((bench_dir / "configs" / f"{base}.json").read_text())
    config.update(TINY_MODEL)
    config["runtime"].update(TINY_RUNTIME)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(config))
    spec = json.loads((bench_dir / "traffic" / f"{traffic}.json").read_text())
    spec.update(TINY_TRAFFIC[traffic])
    (bench_dir / "traffic" / f"tiny-{traffic}.json").write_text(json.dumps(spec))
    name = f"tiny.{traffic}"
    (bench_dir / "limits" / f"{name}.json").write_text(
        json.dumps({"mean_logit_gap": {"limit": limit}})
    )
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny", "source": "a debug-sized decoder for the CPU tests",
        "file": "loadbench/configs/tiny.json", "reduced": list(TINY_MODEL), "why": "CPU tests",
    })
    cell = {"name": name, "config": "tiny", "traffic": f"tiny-{traffic}", "chips": 1, "why": "CPU tests"}
    bench["workloads"].append(cell)
    # the tiny cell reports what the cells of its mix report
    twins = {c["name"] for c in bench["workloads"] if c["traffic"] == traffic}
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if twins & set(metric.get("workloads", ())):
            metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench, cell


def use(root: Path, monkeypatch) -> None:
    monkeypatch.setattr(manifest, "BENCH_DIR", root / "loadbench")
