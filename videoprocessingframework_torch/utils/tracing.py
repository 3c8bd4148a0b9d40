"""Trace spans — the NVTX ranges of the reference, seen by torch.profiler.

The reference wraps every task ``Run()`` in an NVTX range named after the
task (``NVTX_PUSH``/``NVTX_POP``); the JAX package used
``jax.profiler.TraceAnnotation`` scopes with the same names. Here a span
is two things:

* an NVTX range whenever CUDA is up, for an operator's Nsight Systems
  timeline (the per-frame ``DecodeFrame``, ``ResizeSurface``, ... ranges
  are there for that view);
* while a ``torch.profiler`` profile is running, also a
  ``record_function`` scope, so the span lands in the profiler's trace on
  the same clock as the kernels, and the CUDA calls made inside it share
  correlation ids with the device work they launch.

A running profiler is the only switch: with none running, a span costs one
flag check on top of its NVTX push and pop, and never enters
``record_function``.

Spans at the feed's and the model's boundaries:

* :class:`StageTimer` ``measure(stage)`` opens ``<prefix>.<stage>``: the
  ring feed's ``feed.acquire``, ``feed.dispatch`` (with ``feed.register``,
  ``feed.wait``, ``feed.stage``, ``feed.upload`` and ``feed.postproc``
  nested in it) and
  ``feed.drain`` (``io/pool.py``); ``streams.*``, ``multidevice.*``,
  ``loader.*`` and ``transcode.*`` in the other pipelines;
* ``model.forward`` around the forward of ``ResNet`` and ``ViT``
  (``models/graphed.py`` ``GraphedModule.forward``; a video model that
  runs a ViT inside its own forward holds one nested in its own); inside
  it ``model.graph`` around a CUDA graph's copy-in, replay and clone, and
  ``model.graph_capture`` around a capture.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

# the profiler's own flag (a C call of ~0.1 µs): true from a profile's
# start to its stop
_profiling = torch.autograd._profiler_enabled


class trace_range:
    """``with trace_range(name):`` — a named trace span (NVTX_PUSH/POP
    analog, and a ``record_function`` while a profiler runs)."""

    __slots__ = ("name", "_nvtx", "_scope")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._scope = None
        if _profiling():
            self._scope = torch.profiler.record_function(self.name)
            self._scope.__enter__()

    def __exit__(self, *exc) -> None:
        try:
            if self._scope is not None:
                self._scope.__exit__(*exc)
        finally:
            if self._nvtx:
                torch.cuda.nvtx.range_pop()


class StageTimer:
    """Per-stage wall-clock totals for pipeline stats. Each
    ``measure(stage)`` is also the span ``<prefix>.<stage>``."""

    def __init__(self, prefix: str) -> None:
        self.prefix = prefix
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def measure(self, stage: str) -> "_Stage":
        return _Stage(self, stage)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(1, self.counts[k]),
            }
            for k in self.totals
        }


class _Stage:
    """One ``StageTimer.measure`` scope: the span opens inside the timed
    interval, as the stage's work does."""

    __slots__ = ("timer", "stage", "span", "t0")

    def __init__(self, timer: StageTimer, stage: str) -> None:
        self.timer, self.stage = timer, stage
        self.span = trace_range(f"{timer.prefix}.{stage}")

    def __enter__(self) -> None:
        self.t0 = time.perf_counter()
        self.span.__enter__()

    def __exit__(self, *exc) -> None:
        try:
            self.span.__exit__(*exc)
        finally:
            dt = time.perf_counter() - self.t0
            timer, stage = self.timer, self.stage
            timer.totals[stage] = timer.totals.get(stage, 0.0) + dt
            timer.counts[stage] = timer.counts.get(stage, 0) + 1
