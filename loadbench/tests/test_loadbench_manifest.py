"""BENCHMARK.json against the benchmark's rules."""

from __future__ import annotations

import copy
import json

import pytest

from loadbench import manifest
from loadbench.tests.tiny import REPO


@pytest.fixture
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_the_manifest_is_valid(bench):
    assert manifest.problems(bench, REPO) == []
    assert manifest.load(REPO) == bench


@pytest.mark.parametrize("name", ["has space", "a,b", "a/b", "", "é", "x" * 65, ".lead"])
def test_bad_names_are_refused(bench, name):
    broken = copy.deepcopy(bench)
    broken["end_to_end"][1]["name"] = name
    assert any("bad name" in p for p in manifest.problems(broken, REPO))


@pytest.mark.parametrize("unit", ["tokens per second", "", "x" * 17, "µs"])
def test_bad_units_are_refused(bench, unit):
    broken = copy.deepcopy(bench)
    broken["per_layer"][0]["unit"] = unit
    assert any("bad unit" in p for p in manifest.problems(broken, REPO))


def test_a_moves_target_must_be_reported_in_each_cell(bench):
    broken = copy.deepcopy(bench)
    metric = next(m for m in broken["per_layer"] if m["moves"] == "output_tok_s")
    metric["workloads"] = ["mistral7b.agent-loop"]
    found = manifest.problems(broken, REPO)
    assert any("does not report output_tok_s" in p for p in found)


def test_every_configuration_keeps_a_cell(bench):
    broken = copy.deepcopy(bench)
    broken["workloads"] = [c for c in broken["workloads"] if c["config"] != "mistral-7b-v0.3-w8"]
    for m in broken["end_to_end"] + broken["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != "mistral7b-w8.chat-batch"]
    assert any("no cell uses it" in p for p in manifest.problems(broken, REPO))


def test_unknown_keys_bounds_and_sources_are_refused(bench):
    broken = copy.deepcopy(bench)
    broken["per_layer"][0]["why"] = "a metric carries no why"
    broken["end_to_end"][1]["bound"] = 0.3
    broken["end_to_end"][2]["source"] = "program_counter"
    found = "\n".join(manifest.problems(broken, REPO))
    assert "keys" in found and "bound from 0.01 to 0.25" in found and "host_clock or device_trace" in found


def test_missing_files_are_refused(bench):
    broken = copy.deepcopy(bench)
    broken["per_layer"][0]["name"] = "no_reader.ttft"
    broken["workloads"][0]["traffic"] = "no-such-mix"
    found = "\n".join(manifest.problems(broken, REPO))
    assert "no reader metrics/no_reader.ttft.py or metrics/no_reader.py" in found
    assert "no traffic file" in found


def test_a_reader_is_found_by_the_whole_name_then_by_the_stem(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    for name in ("share.py", "share.tok.py"):
        (tmp_path / "metrics" / name).write_text("")
    monkeypatch.setattr(manifest, "BENCH_DIR", tmp_path)
    assert manifest.reader_path("share.tok").name == "share.tok.py"
    assert manifest.reader_path("share.ttft").name == "share.py"
    assert manifest.stem("a.b.c") == "a.b" and manifest.stem("plain") == "plain"


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer(bench):
    for cell in bench["workloads"]:
        e2e = manifest.metrics_of(bench, cell["name"], trace=False)
        layers = manifest.metrics_of(bench, cell["name"], trace=True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layers


def test_each_layer_is_named_alike_and_paths_hold_every_file(bench):
    layers = {}
    for metric in bench["per_layer"]:
        layers.setdefault(metric["name"].split(".")[0], set()).add(metric["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for config in bench["configs"]:
        assert config["file"].startswith("loadbench/")
    assert bench["command"] == ["python3", "loadbench/run.py"]
