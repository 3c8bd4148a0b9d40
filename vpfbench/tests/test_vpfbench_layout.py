"""Every cell of BENCHMARK.json resolves to its files by name, and the
file keeps to the benchmark's contract on names, units and coverage."""

import json
import re

import pytest

from vpfbench import harness

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.load_cell(name)
    assert callable(cell.model.weights) and callable(cell.model.build)
    assert cell.model.flops_per_frame(cell.config) > 0
    assert callable(cell.reference.forward) and callable(cell.kind.run)
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for entry, reader in cell.per_layer:
        assert entry["moves"] in reported
        assert callable(reader.read)


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in metrics])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"pipeline", "feed", "preprocess", "model", "device"}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_command_paths_and_lengths():
    assert BENCH["paths"] == ["vpfbench"]
    assert BENCH["command"] == ["python3", "vpfbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells, 14 runs each, fits in 12 hours
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) == 0
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"]:
            assert "_roofline" in m["name"] and m["unit"] == "%"


def test_configs_are_their_files():
    for c in BENCH["configs"]:
        cfg = harness.read_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


def test_every_file_is_named_by_the_benchmark():
    """The harness needs no list of its own: cells, mixes, metrics and
    configurations are the files the names point at."""
    here, names = harness.HERE, BENCH
    cells = {p.stem for p in (here / "workloads").glob("*.json")}
    assert cells == {w["name"] for w in names["workloads"]}
    metrics = {p.name[:-3] for p in (here / "metrics").glob("*.*.py")}
    assert metrics == {m["name"] for m in names["per_layer"]}
    mixes = {p.stem for p in (here / "traffic").glob("*.json")}
    assert mixes == {w["traffic"] for w in names["workloads"]}

