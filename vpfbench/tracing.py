"""The traced run's device view: ``torch.profiler`` over a few short
stretches spread through the window's second half, read after the window
closes. Once the profiler has started, the host runs slower to the end
of the process (by a quarter to a third, measured against untraced runs
on one machine), so the first half runs as an untraced run does and the
host-clock metrics are read from it alone.

Stretches alternate between two kinds. A device stretch records only the
device's activity (kernels and copies through CUPTI), which costs the
host little: the device's busy and idle time and its operations are read
from these. A host stretch records the host's operations and the
benchmark's ranges as well, which slows the host's enqueue (so its idle
time is not read): each call's device time and the names of the idle
gaps are read from these.

Each stretch starts and stops the profiler between two calls of the
loop that ticks it, so every call of the benchmark's ranges
(``record_function("vpfbench.<name>")``) lies wholly inside a stretch or
outside all of them. A kernel is attributed to the range that was open on
the host thread that launched it (its CUDA runtime call and the kernel
share a correlation id), never by the kernel's name, so a later change
that renames, splits or replaces a kernel is read against the same work.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

RANGE = "vpfbench."


def _profiler(host: bool):
    import warnings

    from torch.profiler import ProfilerActivity, profile

    # each stretch is its own profiler, read on its own
    warnings.filterwarnings("ignore", message=".*clears events at the end")

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts or [ProfilerActivity.CPU])


class Stretches:
    """``count`` stretches of ``length`` seconds centred at even shares of
    the window's second half, device and host stretches in turn.
    ``tick()`` starts or stops the profiler when one is due."""

    def __init__(self, enabled: bool, count: int = 4, length: float = 0.4):
        self.enabled, self.count, self.length = enabled, count, length
        self.due: list = []
        self.prof = None
        self.host = False  # the open stretch records the host too
        self.done: list = []
        #: (start, end) on the host's perf_counter of the part of the
        #: window that ran slower for the profiler: from its first start
        #: on
        self.profiled: list = []

    def start(self, t_window: float, seconds: float) -> None:
        if not self.enabled:
            return
        half = seconds / 2
        length = min(self.length, half / (2 * self.count))
        self.due = [t_window + half + half * (k + 0.5) / self.count
                    - length / 2 for k in range(self.count)]
        self.stretch = length

    def tick(self, now: float | None = None) -> None:
        if not self.enabled:
            return
        now = time.perf_counter() if now is None else now
        if self.prof is not None and now >= self.t_stop:
            self._stop()
        elif self.prof is None and self.due and now >= self.due[0]:
            self.due.pop(0)
            if not self.profiled:
                self.profiled.append((now, float("inf")))
            self.host = len(self.done) % 2 == 1
            self.prof = _profiler(self.host)
            self.prof.start()  # the first start sets CUPTI up
            self.t_ns = time.time_ns()
            self.t_stop = time.perf_counter() + self.stretch

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        bounds = (self.t_ns, time.time_ns())
        self.prof.stop()
        self.done.append((self.host, bounds, self.prof))
        self.prof = None

    def finish(self):
        """Stop a stretch still open, and read every stretch."""
        if self.prof is not None:
            self._stop()
        if not self.enabled:
            return None
        return Summary([(host, bounds, p.profiler.kineto_results.events())
                        for host, bounds, p in self.done])


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Summary:
    """Device operations and idle time of the device stretches, and the
    benchmark's ranges and named idle gaps of the host stretches
    (seconds)."""

    def __init__(self, stretches):
        self.window_s = self.busy_s = self.kernel_s = self.copy_s = 0.0
        self.clipped_s = 0.0  # device time outside the stretches' bounds
        self.ops = defaultdict(float)            # device op name -> s
        self.ranges = defaultdict(list)          # range -> [device s per call]
        self.gaps = defaultdict(float)           # host range -> idle s
        for host, bounds, events in stretches:
            self._read(events, host, bounds)

    def _read(self, events, host: bool, bounds) -> None:
        """``bounds``: the stretch's start and stop on the profiler's
        clock (wall-clock ns), which device times are clipped to."""
        cpu_type = torch.autograd.DeviceType.CPU
        lo, hi = bounds
        device_ops, launches, ranges = [], {}, defaultdict(list)
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            name = e.name()
            if e.device_type() != cpu_type:
                if not name.startswith(RANGE) and not e.is_user_annotation():
                    s, end = max(s, lo), min(s + d, hi)
                    self.clipped_s += (d - max(0, end - s)) / 1e9
                    if end > s:
                        device_ops.append((s, end, name,
                                           e.correlation_id()))
            elif name.startswith(RANGE):
                ranges[e.start_thread_id()].append((s, s + d, name))
            elif name.startswith("cu"):
                launches[e.correlation_id()] = (s, e.start_thread_id())
        kernels = _union((s, e) for s, e, n, _ in device_ops
                         if not _is_copy(n))
        if not host:
            self.window_s += (hi - lo) / 1e9
            busy = _union((s, e) for s, e, _, _ in device_ops)
            self.busy_s += sum(e - s for s, e in busy) / 1e9
            self.kernel_s += sum(e - s for s, e in kernels) / 1e9
            self.copy_s += sum(e - s for s, e, n, _ in device_ops
                               if _is_copy(n)) / 1e9
            for s, e, name, _ in device_ops:
                self.ops[name] += (e - s) / 1e9
            return

        # each call of a range: the device time of what it launched
        for thread in ranges:
            ranges[thread].sort()
        per_call = defaultdict(float)
        for s, e, name, corr in device_ops:
            if _is_copy(name) or corr not in launches:
                continue
            t, thread = launches[corr]
            call = _innermost(ranges.get(thread, []), t)
            if call is not None:
                per_call[call] += (e - s) / 1e9
        for thread, calls in ranges.items():
            for call in calls:
                self.ranges[call[2]].append(per_call.get(call, 0.0))

        # idle gaps between kernels, named by what the thread that
        # launched the next kernel was inside at the gap's middle
        starts = sorted((s, corr) for s, e, n, corr in device_ops
                        if not _is_copy(n))
        for (_, g0), (g1, _) in zip(kernels, kernels[1:]):
            label = "host: no benchmark range"
            i = bisect.bisect_left(starts, (g1, -1))
            if i < len(starts) and starts[i][1] in launches:
                _, thread = launches[starts[i][1]]
                call = _innermost(ranges.get(thread, []), (g0 + g1) // 2)
                if call is not None:
                    label = call[2]
            self.gaps[label] += (g1 - g0) / 1e9

    def device_s(self, range_name: str) -> list:
        """Device seconds of each traced call of ``vpfbench.<name>``."""
        return self.ranges.get(RANGE + range_name, [])

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _innermost(calls, t):
    """The innermost (start, end, name) of sorted ``calls`` holding
    ``t``."""
    best = None
    i = bisect.bisect_right(calls, (t, float("inf"), ""))
    for s, e, name in reversed(calls[:i]):
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, e, name)
            break
    return best
