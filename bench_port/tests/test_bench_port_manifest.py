"""BENCHMARK.json against the benchmark's contract: names, units and
characters, every cell's files found by name, every metric's reader."""

import json
import os
import re

import pytest

from bench_port import harness


def _load(path):
    with open(path) as f:
        return json.load(f)


MANIFEST = _load(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench_port"]
    assert MANIFEST["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    runs = 2 + 14 * 24
    assert (runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["why"])
    assert _line(entry["source"]) and entry["source"].startswith("https://")
    config = _load(os.path.join(harness.ROOT, entry["file"]))
    assert entry["file"].startswith("bench_port/configs/")
    for key in entry["reduced"]:
        assert NAME.match(key) and key in config and key in config["published"]
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cells_resolve_by_name(name):
    entry = {w["name"]: w for w in MANIFEST["workloads"]}[name]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    cell = harness.load_cell(name)
    kind = cell["params"]["kind"]
    assert os.path.exists(os.path.join(harness.HERE, "traffic", f"{kind}.py"))
    assert cell["params"]["why"] == entry["why"]
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


def test_names_units_and_readers():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in MANIFEST["workloads"]}) == len(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(CELLS)
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and "workloads" in m
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           f"{m['name']}.py"))
        moves = {e["name"]: e for e in MANIFEST["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", CELLS))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_under_paths_are_named_from_name_characters():
    for root, dirs, files in os.walk(harness.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), harness.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_at_most_a_quarter_of_the_cells_ask_for_four_cards():
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", [c for c in CELLS if ".train" in c])
def test_train_limits_name_numbers_the_driver_compares(name):
    cell = harness.load_cell(name)
    limits = cell["params"]["limits"]
    driver = harness.traffic(cell["params"]["kind"]).Driver
    assert set(limits) <= set(driver.CHECKED)
    assert {"mismatched_ids", "row_errors"} <= set(limits)
    assert all(v >= 0 for v in limits.values())
