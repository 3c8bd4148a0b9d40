"""The comparison that decides ``correct`` at a size the CPU holds: a
sound run of each cell passes; the lower-precision control fails; and a
run with the timed path broken underneath fails, once for each fault an
inference cell can have. (These runs skip the look for a card and drive
the rest of a run on the CPU, through the port's torch path.)"""

import pytest
import torch

from vpfbench import harness
from vpfbench.control import Control
from vpfbench.program import Program

from . import small

CELLS = small.CELLS


class Stale(Program):
    """Each step hands back the previous step's answers unchanged."""

    def model(self, model_module, cfg, weights):
        m = super().model(model_module, cfg, weights)
        last = []

        def fn(x):
            out = m(x)
            prev = last[0] if last else out
            last[:] = [out]
            return prev[torch.arange(len(out)) % len(prev)]

        return fn


class HalfBatch(Program):
    """Half of each batch is left out, its rows the mean over the rest."""

    def model(self, model_module, cfg, weights):
        m = super().model(model_module, cfg, weights)

        def fn(x):
            k = max(1, len(x) // 2)
            out = m(x[:k])
            rest = out.mean(0, keepdim=True).expand(len(x) - k, -1)
            return torch.cat([out, rest])

        return fn


class Altered(Program):
    """One answer of each batch is altered where it is produced."""

    def model(self, model_module, cfg, weights):
        m = super().model(model_module, cfg, weights)

        def fn(x):
            out = m(x).clone()
            out[-1] = out[-1].flip(0)
            return out

        return fn


def _run(cell, program=None, seed=1234567891011):
    ctx = small.context(cell, seed=seed, program=program)
    if isinstance(program, type):
        ctx.program = program(ctx.cell) if program is Control else program()
    return harness.run_cell(ctx)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell, seed=2 ** 31 + 3)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("broken", [Control, Stale, HalfBatch, Altered])
def test_broken_run_is_not_correct(cell, broken):
    out = _run(cell, broken)
    assert not out.correct, out.checks
