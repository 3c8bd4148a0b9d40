"""Cells by name, one run of a cell, and its result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in files of its own, found by the names in
``BENCHMARK.json``:

* ``configs/<config>.json`` (the file the entry names), its module
  ``models/<config>.py`` and its plain forward ``reference/<config>.py``;
* ``traffic/<traffic>.json``: the mix's ``kind`` and parameters; the kind
  is the generator ``traffic/<kind>.py``, whose ``run(ctx)`` drives the
  window;
* ``workloads/<cell>.json``: the cell's own parameters (over the mix's)
  and the limits of its correctness numbers;
* ``metrics/<metric>.py``: ``read(record)`` → a number, or None where the
  run has nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .program import Program
from .yardstick import peaks

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded when the result is due
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "videoprocessingframework_tpu")

#: sub-seeds, so weights, frames and traffic draw from separate streams
WEIGHTS, FRAMES, TRAFFIC = 1, 2, 3


def load_module(path: Path, package: str):
    name = f"vpfbench.{package}." + re.sub(r"\W", "_", path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    model: object        # models/<config>.py
    reference: object    # reference/<config>.py
    kind: object         # traffic/<kind>.py
    params: dict
    limits: dict
    end_to_end: list
    per_layer: list      # (entry, reader module)


def load_cell(name: str, bench: dict | None = None,
              params: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with everything it names;
    ``params`` overrides traffic parameters (the harness's tests)."""
    bench = bench or read_json(ROOT / "BENCHMARK.json")
    try:
        w = next(c for c in bench["workloads"] if c["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    mix = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    own = read_json(HERE / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [
        (m, load_module(HERE / "metrics" / f"{m['name']}.py", "metrics"))
        for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m
            else m["moves"] in moved)
    ]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=read_json(ROOT / entry["file"]),
        model=load_module(HERE / "models" / f"{w['config']}.py", "models"),
        reference=load_module(HERE / "reference" / f"{w['config']}.py",
                              "reference"),
        kind=load_module(HERE / "traffic" / f"{mix['kind']}.py", "traffic"),
        params={**mix["params"], **own.get("params", {}), **(params or {})},
        limits=own["limits"], end_to_end=e2e, per_layer=per_layer)


class Record:
    """What a run leaves for the per-layer readers: the window's batches
    and host-clock spans, and the trace."""

    def __init__(self):
        self.spans: dict = {}      # name -> [total seconds, count]
        self.trace = None          # tracing.Summary of the traced run
        self.flops_per_frame = 0.0
        self.rates: dict = {}
        self.params: dict = {}
        self.preprocess_frames: list = []  # frames of each traced call
        self.t_window0 = 0.0               # perf_counter at the window's start
        #: each batch of the window: (end on perf_counter, frames, model
        #: enqueue s, feed dispatch s)
        self.batches: list = []
        self.profiled: list = []           # (start, end) of each stretch

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        s = self.spans.setdefault(name, [0.0, 0])
        s[0] += seconds
        s[1] += count

    def mean_ms(self, name: str):
        total, count = self.spans.get(name, (0.0, 0))
        return 1e3 * total / count if count else None


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                       # process start, perf_counter
    program: Program = field(default_factory=Program)
    record: Record = field(default_factory=Record)

    def sub_seed(self, k: int) -> int:
        return (self.seed << 4) | k

    def mark(self, what: str) -> None:
        """A set-up step done: seconds since the process started."""
        self.say(f"set-up: {what} at {time.perf_counter() - self.t0:.3f} s")

    def say(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict                # metric name -> value
    checks: dict                    # name -> (value, limit)
    memory_peak: int

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= lim
                   for v, lim in self.checks.values())


@contextlib.contextmanager
def strict_float32():
    """float32 products without TF32, for the reference."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(ctx: Context) -> Outcome:
    cell = ctx.cell
    ctx.record.params = cell.params
    ctx.record.flops_per_frame = cell.model.flops_per_frame(cell.config)
    return cell.kind.run(ctx)


def result_line(ctx: Context, out: Outcome, device: dict,
                breakdown=None) -> dict:
    cell, rec = ctx.cell, ctx.record
    metrics = {}
    if ctx.trace:
        for entry, reader in cell.per_layer:
            value = reader.read(rec)
            if value is None:
                ctx.say(f"{entry['name']}: the run recorded nothing to read")
            else:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": out.end_to_end[entry["name"]],
                                      "unit": entry["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def main(args, t0: float) -> int:
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("vpfbench: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"vpfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, t0=t0)
    name = torch.cuda.get_device_name(device)
    ctx.record.rates = peaks(name)
    ctx.say(f"card: {card_line()}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; cell {cell.name} seed {args.seed} "
            f"seconds {args.seconds} trace {args.trace}")
    ctx.mark("torch imported and the card found")
    out = run_cell(ctx)
    found = forbidden_modules()
    if found:
        print(f"vpfbench: the run loaded {', '.join(found)}; the port may "
              f"not use JAX or the JAX package", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": name, "count": cell.chips,
                   "memory_peak_bytes": out.memory_peak}
    breakdown = None
    if ctx.trace:
        s = ctx.record.trace
        if s is None or s.window_s <= 0:
            print("vpfbench: the traced run recorded no trace",
                  file=sys.stderr)
            return 4
        device_info.update(busy_s=s.busy_s, window_s=s.window_s)
        ctx.say(f"trace: {s.window_s:.4f} s in device stretches, busy "
                f"{s.busy_s:.4f} s, kernels {s.kernel_s:.4f} s, copies "
                f"{s.copy_s:.4f} s ({100 * s.copy_s / s.window_s:.2f}% of "
                f"the stretches); device time outside the bounds "
                f"{s.clipped_s:.6f} s")
        breakdown = s.breakdown()
    line = result_line(ctx, out, device_info, breakdown)
    for k, (v, lim) in out.checks.items():
        print(f"check {k}: {v!r} (limit {lim!r}) "
              f"{'ok' if math.isfinite(v) and v <= lim else 'FAILED'}",
              file=sys.stderr)
    print(f"correct: {out.correct}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
