"""``BENCHMARK.json`` against the benchmark's rules: names and units from
the allowed characters, every file a cell or metric names present, every
per-layer metric's cells reporting the end-to-end metric it moves, every
configuration used, and one chip a cell."""
from __future__ import annotations

import json
import re

import pytest

from pbtiny import PORTBENCH, REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_top_level_and_names():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_and_metrics(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for path in (f"configs/{w['config']}.json", f"traffic/{w['traffic']}.json",
                 f"cells/{cell}.json"):
        assert (PORTBENCH / path).is_file(), path
    e2e = {m["name"] for m in BENCH["end_to_end"] if cell in _cells_of(m)}
    per = [m for m in BENCH["per_layer"] if cell in _cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_every_config_used_and_filed():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_per_layer_metric_has_a_reader():
    layers = {}
    for m in BENCH["per_layer"]:
        assert (PORTBENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values()), layers
