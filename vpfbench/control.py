"""The lower-precision control: the plain reference put in the program's
place, one precision below what the configuration states. The model
states bfloat16, so its products take fp8 (e4m3, one scale a tensor);
the pre-processing states float32, so it computes in bfloat16. A run
with this in place must come out not correct, or the comparison could
not tell such a change from a sound run.

Run on the card at a cell's own size, on several seeds, together with
the program's own readings on a dozen seeds:

    python3 -m vpfbench.control \
        --workload <cell> --seeds 11,12,... --control-seeds 21,22,23 \
        --seconds 4

One JSON line a run (``"side"``: program or control) with each number
compared; the limits in ``workloads/<cell>.json`` are set from them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .program import Program
from .reference import lowp
from .reference.preprocess import preprocess


class Control(Program):
    def __init__(self, cell):
        self.cell = cell

    def pipeline(self, params: dict, device):
        from .check import space_range

        space, rng = space_range(params)
        out = params["out_size"]

        def fn(y, u, v):
            return preprocess(y, u, v, out, out, space, rng,
                              dtype=torch.bfloat16)

        return fn

    def model(self, model_module, cfg: dict, weights: dict):
        forward = self.cell.reference.forward
        return lambda x: forward(weights, x, cfg, cast=lowp.fp8)


def main(argv=None) -> int:
    from . import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rates = harness.peaks(torch.cuda.get_device_name(device))
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    runs = [("program", int(s)) for s in args.seeds.split(",") if s]
    runs += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for side, seed in runs:
        cell = harness.load_cell(args.workload)
        program = Control(cell) if side == "control" else Program()
        ctx = harness.Context(cell=cell, seed=seed, seconds=args.seconds,
                              trace=False, device=device,
                              t0=time.perf_counter(), program=program)
        ctx.record.rates = rates
        try:
            out = harness.run_cell(ctx)
            line = {"side": side, "seed": seed, "correct": out.correct,
                    "checks": {k: v for k, (v, _lim) in out.checks.items()},
                    "end_to_end": out.end_to_end}
        except Exception as e:  # a control that crashes has failed
            line = {"side": side, "seed": seed, "error": repr(e)}
        print(json.dumps({"workload": args.workload, **line}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
