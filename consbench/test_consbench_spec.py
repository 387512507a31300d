"""BENCHMARK.json against the benchmark's contract, and the harness
finding every configuration, traffic mix, driver and metric by name."""
import json
import pathlib
import re

import pytest

from consbench import run

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["consbench"]
    assert BENCH["command"][1] == "consbench/run.py"
    assert all(TEXT.match(w) for w in BENCH["command"])


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_moves_reported_with_the_layer_metric(cell):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric; each per-layer metric's `moves` is reported in
    each cell that reports the per-layer metric."""
    e2e = {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
    layer = run.cell_metrics(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)


def test_every_entry_used_and_found_by_name():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for w in BENCH["workloads"]:
        wl, config, traffic = run.cell_spec(BENCH, w["name"])
        assert config["name"] == w["config"]
        assert set(config["reduced"]) == set(
            {c["name"]: c for c in BENCH["configs"]}[w["config"]]["reduced"])
        assert (ROOT / "consbench" / "drivers"
                / f"{traffic['driver']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.load_module(
            ROOT / "consbench" / "metrics" / f"{m['name']}.py", "m").read)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        if "moves" in m:
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_full_check_fits():
    n = 24
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200
