"""``BENCHMARK.json``: loading, the benchmark's rules on it, and lookups.

:func:`problems` lists every rule a manifest breaks (an empty list is a
valid manifest); :func:`load` reads one and raises :class:`ManifestError`
with those problems.  The rules are the ones the harness depends on: names
and units in their alphabets, every cell's configuration and traffic mix
present as files, every per-layer metric's reader present, its ``moves``
target reported in each of its cells, every configuration used by a cell.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}

BENCH_DIR = Path(__file__).resolve().parent


class ManifestError(ValueError):
    """A ``BENCHMARK.json`` that breaks the benchmark's rules."""


def _line(text: Any) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def cells_of(metric: dict, workloads: list) -> list[str]:
    """The cells that report ``metric``: its ``workloads`` key, else every
    cell (an end-to-end metric) or every cell reporting its ``moves``."""
    if "workloads" in metric:
        return list(metric["workloads"])
    return [cell["name"] for cell in workloads]


def problems(manifest: Any, root: Path) -> list[str]:
    """Every rule ``manifest`` (a parsed ``BENCHMARK.json``) breaks, with
    the files it names looked up under ``root``."""
    out: list[str] = []
    if not isinstance(manifest, dict):
        return ["the manifest is not a JSON object"]
    keys = set(manifest)
    if keys != TOP_KEYS:
        out.append(f"top-level keys {sorted(keys)} != {sorted(TOP_KEYS)}")
    paths = manifest.get("paths") or []
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        out.append("paths: 1 to 16 directories")
    for path in paths:
        if not (isinstance(path, str) and PATH.match(path)) or path.startswith("/") or ".." in path:
            out.append(f"paths: bad path {path!r}")
    command = manifest.get("command") or []
    if not (isinstance(command, list) and 1 <= len(command) <= 32 and all(map(_line, command))):
        out.append("command: 1 to 32 words of 1 to 200 characters")
    seconds = manifest.get("run_seconds")
    if not (isinstance(seconds, int) and 1 <= seconds <= 51):
        out.append("run_seconds: a whole number from 1 to 51")

    names: set[str] = set()

    def named(entry: dict, where: str) -> str:
        name = entry.get("name")
        if not (isinstance(name, str) and NAME.match(name)):
            out.append(f"{where}: bad name {name!r}")
            return str(name)
        if name in names:
            out.append(f"{where}: the name {name!r} is taken")
        names.add(name)
        return name

    configs = manifest.get("configs") or []
    if not 1 <= len(configs) <= 24:
        out.append("configs: 1 to 24 entries")
    config_names: set[str] = set()
    files: set[str] = set()
    for entry in configs:
        name = named(entry, "configs")
        config_names.add(name)
        if set(entry) != CONFIG_KEYS:
            out.append(f"config {name}: keys {sorted(entry)} != {sorted(CONFIG_KEYS)}")
        if not (_line(entry.get("source")) and _line(entry.get("why"))):
            out.append(f"config {name}: source and why are one line of 1 to 200 characters")
        file = entry.get("file", "")
        if file in files:
            out.append(f"config {name}: its file is another configuration's")
        files.add(file)
        if not any(str(file).startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"config {name}: file {file!r} lies outside paths")
        elif not (root / file).is_file():
            out.append(f"config {name}: no file {file}")
        reduced = entry.get("reduced")
        if not (isinstance(reduced, list) and len(reduced) <= 16
                and all(isinstance(k, str) and NAME.match(k) for k in reduced)):
            out.append(f"config {name}: reduced is a list of at most 16 names")

    workloads = manifest.get("workloads") or []
    if not 1 <= len(workloads) <= 24:
        out.append("workloads: 1 to 24 cells")
    pairs: set[tuple] = set()
    used: set[str] = set()
    for cell in workloads:
        name = named(cell, "workloads")
        if set(cell) != CELL_KEYS:
            out.append(f"cell {name}: keys {sorted(cell)} != {sorted(CELL_KEYS)}")
        if cell.get("chips") not in (1, 4):
            out.append(f"cell {name}: chips is 1 or 4")
        if not _line(cell.get("why")):
            out.append(f"cell {name}: why is one line of 1 to 200 characters")
        config, traffic = cell.get("config"), cell.get("traffic")
        if config not in config_names:
            out.append(f"cell {name}: unknown configuration {config!r}")
        used.add(config)
        if not (isinstance(traffic, str) and NAME.match(traffic)):
            out.append(f"cell {name}: bad traffic name {traffic!r}")
        elif not (BENCH_DIR / "traffic" / f"{traffic}.json").is_file():
            out.append(f"cell {name}: no traffic file traffic/{traffic}.json")
        if (config, traffic) in pairs:
            out.append(f"cell {name}: configuration and traffic appear twice")
        pairs.add((config, traffic))
        if not (BENCH_DIR / "limits" / f"{name}.json").is_file():
            out.append(f"cell {name}: no limits/{name}.json")
    four = sum(1 for cell in workloads if cell.get("chips") == 4)
    if four > max(1, len(workloads) // 4):
        out.append("workloads: too many four-chip cells")
    for name in sorted(config_names - used):
        out.append(f"config {name}: no cell uses it")
    cell_names = {cell.get("name") for cell in workloads}

    e2e = manifest.get("end_to_end") or []
    if not 1 <= len(e2e) <= 16:
        out.append("end_to_end: 1 to 16 metrics")
    reported: dict[str, set] = {}
    for metric in e2e:
        name = named(metric, "end_to_end")
        if set(metric) - {"workloads"} != E2E_KEYS:
            out.append(f"metric {name}: keys {sorted(metric)}")
        out.extend(_metric_common(metric, name, cell_names))
        if metric.get("source") not in SOURCES_E2E:
            out.append(f"metric {name}: an end-to-end source is host_clock or device_trace")
        bound = metric.get("bound")
        if not (isinstance(bound, (int, float)) and 0.01 <= bound <= 0.25):
            out.append(f"metric {name}: bound from 0.01 to 0.25")
        reported[name] = set(cells_of(metric, workloads))
    if "setup_s" not in reported:
        out.append("end_to_end: setup_s is missing")
    for cell in cell_names:
        if sum(cell in cells for cells in reported.values()) < 2:
            out.append(f"cell {cell}: reports setup_s and at least one other end-to-end metric")

    per_layer = manifest.get("per_layer") or []
    if not 1 <= len(per_layer) <= 128:
        out.append("per_layer: 1 to 128 metrics")
    layered: set[str] = set()
    for metric in per_layer:
        name = named(metric, "per_layer")
        if set(metric) - {"workloads"} != LAYER_KEYS:
            out.append(f"metric {name}: keys {sorted(metric)}")
        out.extend(_metric_common(metric, name, cell_names))
        if metric.get("source") not in SOURCES:
            out.append(f"metric {name}: unknown source {metric.get('source')!r}")
        if not _line(metric.get("layer")):
            out.append(f"metric {name}: layer is one line of 1 to 200 characters")
        moves = metric.get("moves")
        if moves not in reported:
            out.append(f"metric {name}: moves {moves!r}, no end-to-end metric")
        else:
            for cell in cells_of(metric, workloads):
                if cell not in reported[moves]:
                    out.append(f"metric {name}: cell {cell} does not report {moves}")
        if not reader_path(name).is_file():
            out.append(f"metric {name}: no reader metrics/{name}.py or metrics/{stem(name)}.py")
        layered.update(cells_of(metric, workloads))
    for cell in sorted(cell_names - layered):
        out.append(f"cell {cell}: reports no per-layer metric")
    return out


def stem(name: str) -> str:
    """A metric's name up to its last dot (``mfu`` of ``mfu.tok``): the
    quantity, where the part after the dot names what it moves."""
    return name.rsplit(".", 1)[0]


def reader_path(name: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py`` where there is
    one, else ``metrics/<stem>.py``, which every metric of that stem shares."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    return own if own.is_file() else BENCH_DIR / "metrics" / f"{stem(name)}.py"


def _metric_common(metric: dict, name: str, cells: set) -> list[str]:
    out = []
    if not (isinstance(metric.get("unit"), str) and UNIT.match(metric["unit"])):
        out.append(f"metric {name}: bad unit {metric.get('unit')!r}")
    if metric.get("better") not in ("lower", "higher"):
        out.append(f"metric {name}: better is lower or higher")
    if "workloads" in metric:
        listed = metric["workloads"]
        if not (isinstance(listed, list) and listed and set(listed) <= cells):
            out.append(f"metric {name}: workloads names unknown cells")
    return out


def load(root: Path) -> dict:
    """The valid ``BENCHMARK.json`` under ``root``; raises
    :class:`ManifestError` naming every rule it breaks."""
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise ManifestError(f"no {path}")
    manifest = json.loads(path.read_text())
    found = problems(manifest, root)
    if found:
        raise ManifestError("; ".join(found))
    return manifest


def cell(manifest: dict, name: str) -> dict:
    for entry in manifest["workloads"]:
        if entry["name"] == name:
            return entry
    raise ManifestError(f"no cell {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for entry in manifest["configs"]:
        if entry["name"] == name:
            return entry
    raise ManifestError(f"no configuration {name!r} in BENCHMARK.json")


def metrics_of(manifest: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer metrics."""
    table = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in table if cell_name in cells_of(m, manifest["workloads"])]
