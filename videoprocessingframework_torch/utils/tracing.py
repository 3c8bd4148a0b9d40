"""Trace annotations — the NVTX ranges of the reference.

The reference wraps every task ``Run()`` in an NVTX range named after the
task; the JAX package used ``jax.profiler.TraceAnnotation`` scopes with
the same names. Here they are ``torch.cuda.nvtx`` ranges when CUDA is up,
so Nsight and ``torch.profiler`` timelines show the same stage labels;
without CUDA a range is a no-op.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator

import torch

@contextlib.contextmanager
def trace_range(name: str) -> Iterator[None]:
    """Named trace scope (NVTX_PUSH/POP analog)."""
    if not torch.cuda.is_available():
        yield
        return
    with torch.cuda.nvtx.range(name):
        yield


class StageTimer:
    """Lightweight per-stage wall-clock accumulation for pipeline stats."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(1, self.counts[k]),
            }
            for k in self.totals
        }
