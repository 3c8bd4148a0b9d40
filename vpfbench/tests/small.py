"""A cell at a size the CPU runs in seconds: the configurations as
published, at their 224×224 input, fed 272×480 frames (a quarter of
1080p's sides, the height rounded to a multiple of 4) through the port's
torch path in batches of 4. At the model's own input size the
comparison's readings are those of the card's runs (PERF.md §6), so the
cells' own limits hold here."""

from __future__ import annotations

import time

import torch

from vpfbench import harness, yardstick
from vpfbench.program import Program

SMALL = {"width": 480, "height": 272, "batch": 4, "out_size": 224,
         "kernel": "torch", "warmup_batches": 2, "check_batches": 2,
         "check_input_batches": 1}


CELLS = [w["name"] for w in
         harness.read_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def context(cell_name: str, seed: int = 1234567891011, program=None,
            seconds: float = 0.6, trace: bool = False) -> harness.Context:
    cell = harness.load_cell(cell_name, params=SMALL)
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds,
                          trace=trace, device=torch.device("cpu"),
                          t0=time.perf_counter(),
                          program=program or Program())
    ctx.record.rates = yardstick.peaks("NVIDIA H100 80GB HBM3")
    return ctx
