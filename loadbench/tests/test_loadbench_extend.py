"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as files and BENCHMARK.json entries alone, and the harness
runs them (on the CPU, at a debug size)."""

from __future__ import annotations

import json

import torch

from loadbench import harness, manifest
from loadbench.tests import tiny

NEW_METRIC = '''"""Tokens the window's requests were served, a count (a test metric)."""


def read(r):
    return sum(len(x.tokens) for x in r.in_window()) or None
'''


def test_a_new_cell_runs_from_files_alone(tmp_path, monkeypatch):
    root, bench, cell = tiny.make_root(tmp_path, "chat-batch")
    (root / "loadbench" / "metrics" / "served_tokens.tok.py").write_text(NEW_METRIC)
    bench["per_layer"].append({
        "name": "served_tokens.tok", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "client", "moves": "output_tok_s",
        "workloads": [cell["name"]],
    })
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    tiny.use(root, monkeypatch)
    assert manifest.load(root) == bench
    for trace in (False, True):
        result, diagnostics = harness.run(bench, cell, 2**31 + 11, 2.5, trace,
                                          torch.device("cpu"), 0.0)
        assert result["correct"], result["checks"]
        assert result["attempted"] > 0 and result["failed"] == 0
        names = set(result["metrics"])
        if trace:
            assert {"served_tokens.tok", "occupancy.tok", "ttft_p95_ms.tok"} <= names
            assert "breakdown" in result and "busy_s" in result["device"]
            assert diagnostics["profiler_stop_s"] is not None
        else:
            assert {"setup_s", "output_tok_s"} == names
        assert list(result)[-1] == "checks"


def test_the_agent_mix_reuses_prefixes_on_the_cpu(tmp_path, monkeypatch):
    root, bench, cell = tiny.make_root(tmp_path, "agent-loop")
    tiny.use(root, monkeypatch)
    seen = []
    per_layer = harness.per_layer
    monkeypatch.setattr(harness, "per_layer", lambda names, r: seen.append(r) or per_layer(names, r))
    result, diagnostics = harness.run(bench, cell, 5, 2.5, True, torch.device("cpu"), 0.0)
    # the window runs untraced: the profiler starts after it has closed
    (r,) = seen
    assert r.trace.host_start - diagnostics["profiler_start_s"] > r.window[1]
    assert all(x.due < r.window[1] for x in r.in_window())
    assert any(x.due > r.trace.host_start - 1.0 for x in r.records)  # the traced phase's
    assert result["correct"], result["checks"]
    assert result["metrics"]["prefix_hit_share.ttft"]["value"] > 0
    assert diagnostics["counters"]["prefix_hits"] > 0
