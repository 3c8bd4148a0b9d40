"""The command as a check runs it. Without a card it must fail and
print no result; on the card (``python -m pytest -m cuda vpfbench/tests``)
each cell must print a correct result line."""

import json
import subprocess
import sys

import pytest
import torch

from vpfbench import harness

CELLS = [w["name"] for w in
         harness.read_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def _run(cell, seconds, trace=0, cwd=harness.ROOT):
    return subprocess.run(
        [sys.executable, "vpfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=cwd, capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(CELLS[0], 1)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    program is missing, so the run fails with no result."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "vpfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(CELLS[0], 1, cwd=tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = _run(cell, 3)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
