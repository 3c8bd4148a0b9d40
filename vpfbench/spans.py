"""Where the host's time goes in an offline cell, read from the port's own
spans (``videoprocessingframework_torch.utils.tracing``: ``feed.*`` from
the ring feed's stage timer, ``model.forward``):

    python3 vpfbench/spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with an NVIDIA GPU. It builds
the cell as ``traffic/offline.py`` does and drives the same loop; it is
not a run of the benchmark and prints no result line of it. It prints one
JSON object as the last line of standard output:

* ``stage_ms``: the ring timer's stages, mean ms a batch over the first
  half of the window (no profiler started yet, as the host-clock readers
  read), and ``model.enqueue`` beside them;
* from host stretches (``torch.profiler`` over host and device) in the
  second half: the idle gaps between kernels named by
  :class:`SpanSummary`'s paths (``gaps``: the names ``tracing.Summary``
  gives the same gaps), the launches of each ``model.forward``, and
  ``paired_batches``: ``enqueue_ms`` and ``dispatch_ms`` of batches with
  the port's spans and of the batches between them, held off (the
  spans' cost while a profiler runs);
* ``span_us``: one span's host cost with no profiler running and with
  one running, timed in a loop.

:class:`SpanSummary` reads what :class:`tracing.Summary` reads, unchanged,
and besides the port's spans: a per-layer reader of the benchmark could
take its ``paths`` and ``launches`` once ``tracing.Stretches.finish``
builds it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from vpfbench.tracing import (  # noqa: E402
    RANGE,
    Summary,
    _innermost,
    _is_copy,
    _profiler,
    _union,
)

#: the span of the models' forward in the port
FORWARD = "model.forward"
#: the label of a gap with no profiler op open on the launching thread
PYTHON = "python"
#: Summary's label of a gap outside every benchmark range
NO_RANGE = "host: no benchmark range"


class SpanSummary(Summary):
    """:class:`Summary`, and from the host stretches besides:

    * ``paths``: idle seconds between kernels by the path (a tuple of
      labels: range, program span where one is open, op) of what the
      thread that launched the next kernel had open at the gap's middle:
      the innermost ``vpfbench.*`` range (the label ``Summary.gaps`` has),
      then the innermost program span inside it (a ``record_function``
      scope not named ``vpfbench.*``), then the outermost profiler op
      open below that, or ``python`` with no op open;
    * ``launches``: for each outermost ``model.forward`` span, the host
      calls inside it on its thread whose correlation id is on at least
      one device event (kernels, copies and memsets; a CUDA graph launch
      is one call).

    Program spans are kept apart from the benchmark's ranges, so every
    reading of :class:`Summary` is the same with or without them."""

    def __init__(self, stretches):
        self.paths = defaultdict(float)
        self.launches: list = []
        super().__init__(stretches)

    def _read(self, events, host: bool, bounds) -> None:
        super()._read(events, host, bounds)
        if host:
            self._read_spans(events, bounds)

    def _read_spans(self, events, bounds) -> None:
        cpu_type = torch.autograd.DeviceType.CPU
        lo, hi = bounds
        calls, spans, ops = (defaultdict(list) for _ in range(3))
        runtime, on_device, kernels = {}, set(), []
        for e in events:
            s, d, name = e.start_ns(), e.duration_ns(), e.name()
            if e.device_type() != cpu_type:
                if name.startswith(RANGE) or e.is_user_annotation():
                    continue
                on_device.add(e.correlation_id())
                s, end = max(s, lo), min(s + d, hi)
                if end > s and not _is_copy(name):
                    kernels.append((s, end, e.correlation_id()))
                continue
            thread = e.start_thread_id()
            if name.startswith(RANGE):
                calls[thread].append((s, s + d, name))
                continue
            if name.startswith("cu"):  # as Summary finds launches
                runtime[e.correlation_id()] = (s, thread)
            if e.is_user_annotation():
                spans[thread].append((s, s + d, name))
            else:
                ops[thread].append((s, s + d, name))
        for table in (calls, spans):
            for rows in table.values():
                rows.sort()
        roots = {t: _roots(rows) for t, rows in ops.items()}

        for thread, rows in spans.items():
            calls_at = sorted(t for corr, (t, th) in runtime.items()
                              if th == thread and corr in on_device)
            end = None
            for s, e, name in rows:
                if name != FORWARD or (end is not None and s < end):
                    continue  # not a forward, or one inside another
                end = e
                self.launches.append(bisect.bisect_right(calls_at, e)
                                     - bisect.bisect_left(calls_at, s))

        # the gaps Summary names, each named further down
        union = _union((s, e) for s, e, _ in kernels)
        starts = sorted((s, corr) for s, _, corr in kernels)
        for (_, g0), (g1, _) in zip(union, union[1:]):
            path = (NO_RANGE,)
            i = bisect.bisect_left(starts, (g1, -1))
            if i < len(starts) and starts[i][1] in runtime:
                _, thread = runtime[starts[i][1]]
                path = _path(calls.get(thread, []), spans.get(thread, []),
                             roots.get(thread, []), (g0 + g1) // 2)
            self.paths[path] += (g1 - g0) / 1e9

    def span_share(self, ranges=("vpfbench.feed", "vpfbench.model")):
        """Share of the idle seconds under ``ranges`` whose path names a
        program span, or None without such seconds."""
        under = {p: s for p, s in self.paths.items() if p[0] in ranges}
        total = sum(under.values())
        if total <= 0:
            return None
        return sum(s for p, s in under.items() if len(p) == 3) / total


def _roots(ops) -> list:
    """The (start, end, name) of ``ops`` that no other op holds, in
    order (ops on one thread nest)."""
    out, end = [], None
    for s, e, name in sorted(ops, key=lambda o: (o[0], -o[1])):
        if end is None or s >= end:
            out.append((s, e, name))
            end = e
    return out


def _path(calls, spans, roots, t) -> tuple:
    """The labels of what was open at ``t``: the innermost benchmark
    range, the innermost program span inside it if any, and the outermost
    op inside that (or ``python``)."""
    call = _innermost(calls, t)
    path = [call[2] if call is not None else NO_RANGE]
    floor = call[0] if call is not None else float("-inf")
    span = _innermost([s for s in spans if s[0] >= floor], t)
    if span is not None:
        path.append(span[2])
        floor = span[0]
    i = bisect.bisect_right(roots, (t, float("inf"), ""))
    op = roots[i - 1] if i else None
    if op is not None and op[0] >= floor and op[0] <= t <= op[1]:
        path.append(op[2])
    else:
        path.append(PYTHON)
    return tuple(path)


def span_cost_us(n: int = 20000) -> dict:
    """µs a ``trace_range`` and a ``StageTimer.measure`` cost on this
    host, with no profiler running and with one recording the host."""
    from torch.profiler import ProfilerActivity, profile

    from videoprocessingframework_torch.utils.tracing import (
        StageTimer,
        trace_range,
    )

    def loop(make):
        t = time.perf_counter()
        for _ in range(n):
            with make():
                pass
        return time.perf_counter() - t

    timer = StageTimer("cost")
    kinds = {"empty": contextlib.nullcontext,
             "trace_range": lambda: trace_range("cost"),
             "measure": lambda: timer.measure("cost")}
    out = {}
    for profiled in (False, True):
        prof = profile(activities=[ProfilerActivity.CPU]) if profiled \
            else None
        if prof is not None:
            prof.start()
        took = {k: min(loop(make) for _ in range(3))
                for k, make in kinds.items()}
        if prof is not None:
            prof.stop()
        tag = "on" if profiled else "off"
        for k in ("trace_range", "measure"):
            out[f"{k}.{tag}"] = 1e6 * (took[k] - took["empty"]) / n
    return out


def profile_cell(ctx, stretches: int = 6, length: float = 0.4,
                 paired_length: float = 1.2) -> dict:
    """The offline loop of ``ctx.cell``: its first half untraced, then
    ``stretches`` host stretches spread through the second half after one
    that is not read (the profiler's first start sets CUPTI up). The even
    ones, ``length`` seconds, are read by :class:`SpanSummary`; in the
    odd ones, ``paired_length`` seconds, the port's spans are held off
    in every other pair of batches (so each kind uses both staging
    buffers of the ring's depth 2), and batches with and without them
    run at one host speed."""
    from torch.profiler import record_function

    from videoprocessingframework_torch.utils import tracing as port

    from vpfbench import frames
    from vpfbench.harness import FRAMES, WEIGHTS
    from vpfbench.traffic.offline import _ring

    cell, p, dev = ctx.cell, ctx.cell.params, ctx.device
    batch, h, w = p["batch"], p["height"], p["width"]
    weights = cell.model.weights(cell.config, ctx.sub_seed(WEIGHTS), dev)
    model = ctx.program.model(cell.model, cell.config, weights)
    pipe = ctx.program.pipeline(p, dev)
    y, u, v = frames.yuv420(p["ring_slots"] * batch, h, w,
                            ctx.sub_seed(FRAMES), dev)
    ring = _ring(frames.ring_slots(y, u, v, batch), w, h, batch, dev)
    del y, u, v

    def post(*planes):
        with record_function("vpfbench.preprocess"):
            return pipe(*planes)

    ring.rewind(1 << 62)
    feed = ring.batches(post, depth=p["depth"])
    timer = ring.timer

    def step():
        before = dict(timer.totals)
        with record_function("vpfbench.feed"):
            x = next(feed)
        ring.order.popleft()
        t = time.perf_counter()
        with record_function("vpfbench.model"):
            model(x)
        enqueue = time.perf_counter() - t
        deltas = {k: v - before.get(k, 0.0) for k, v in timer.totals.items()}
        deltas["model.enqueue"] = enqueue
        return deltas

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    real = port._profiling
    paired = {True: [], False: []}  # spans on -> per-batch deltas

    def stretch(toggle: bool):
        prof = _profiler(True)
        prof.start()
        t_ns = time.time_ns()
        t_stop = time.perf_counter() + (paired_length if toggle else length)
        k = 0
        try:
            # a batch of each kind at least, however slow the batches
            while k < 1 + 2 * toggle or time.perf_counter() < t_stop:
                on = not toggle or k // 2 % 2 == 0
                port._profiling = real if on else (lambda: False)
                row = step()
                if toggle:
                    paired[on].append(row)
                k += 1
        finally:
            port._profiling = real
        sync()
        bounds = (t_ns, time.time_ns())
        prof.stop()
        return bounds, prof.profiler.kineto_results.events()

    traced = []
    with torch.no_grad():
        for _ in range(p["warmup_batches"]):
            step()
        sync()
        t_w0 = time.perf_counter()
        half = ctx.seconds / 2
        untraced = []
        while time.perf_counter() - t_w0 < half:
            untraced.append(step())
        gap = half / (stretches + 1)
        for k in range(-1, stretches):
            due = t_w0 + half + gap * (k + 1) + (gap - length) / 2
            while time.perf_counter() < due:
                step()
            sync()
            bounds, events = stretch(toggle=k >= 0 and k % 2 == 1)
            if k >= 0 and k % 2 == 0:
                traced.append((True, bounds, events))
        sync()
        feed.close()
    summary = SpanSummary(traced)

    def mean_ms(rows, key):
        vals = [r.get(key, 0.0) for r in rows]
        return 1e3 * sum(vals) / len(vals) if vals else None

    def median_ms(rows, key):
        vals = [r.get(key, 0.0) for r in rows]
        return 1e3 * statistics.median(vals) if vals else None

    stages = sorted({k for r in untraced for k in r})
    paths = sorted(summary.paths.items(), key=lambda kv: -kv[1])
    launches = summary.launches
    return {
        "batches": len(untraced),
        "stage_ms": {k: mean_ms(untraced, k) for k in stages},
        # the nested stages never outlast their dispatch, batch by batch
        "parts_within_dispatch": all(
            sum(r.get(k, 0.0) for k in ("wait", "stage", "upload",
                                        "postproc")) <= r["dispatch"]
            for r in untraced),
        "paired_batches": {
            ("spans_on" if on else "spans_off"): {
                "batches": len(rows),
                "enqueue_ms": mean_ms(rows, "model.enqueue"),
                "dispatch_ms": mean_ms(rows, "dispatch"),
                "enqueue_median_ms": median_ms(rows, "model.enqueue"),
                "dispatch_median_ms": median_ms(rows, "dispatch")}
            for on, rows in paired.items()},
        "idle_gaps": [["/".join(n), s] for n, s in paths[:25]],
        "idle_gap_s": sum(summary.paths.values()),
        "gaps": dict(summary.gaps),
        "span_labelled_share": summary.span_share(),
        "launches": {
            "calls": len(launches),
            "median": statistics.median(launches) if launches else None,
            "min": min(launches, default=None),
            "max": max(launches, default=None),
            "counts": sorted(set(launches))},
        "ranges_device_s": {n: sum(v) for n, v in summary.ranges.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from vpfbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("vpfbench/spans.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=True, device=device, t0=T0)
    ctx.say(f"card: {harness.card_line()}; torch {torch.__version__}; "
            f"cell {cell.name} seed {args.seed} seconds {args.seconds}")
    out = profile_cell(ctx)
    out["span_us"] = span_cost_us()
    out["device"] = torch.cuda.get_device_name(device)
    for name, s in out["idle_gaps"]:
        ctx.say(f"idle {s:.6f} s  {name}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
