"""CUDA-graph replay of a model's inference forward.

An eager forward of the package's models makes hundreds of launches
(ResNet-50 378, ViT-S/16 510), each costing the host tens of µs: the
host, not the card, sets the pace of a batch. :class:`GraphedModule` is
the base of such a model: its ``forward`` opens the ``model.forward``
span and hands the model's eager body, ``_forward``, to the model's
:class:`GraphCache`. The cache keeps the forward captured as one CUDA
graph an input signature, and replays it where the call can observe that
a replay computes what the eager forward would:

* the input is a plain CUDA tensor; gradients are off; the model and its
  submodules are in inference mode; autocast is off; no stream capture,
  ``torch.compile``/``torch.export`` trace, JIT trace, dispatch or
  function mode is open; no submodule has a forward hook or its own
  ``forward`` (host work a replay would skip);
* the signature (shape, strides, dtype, device, inference mode and the
  switches that cuBLAS and cuDNN read when the forward is captured) has
  run eagerly ``EAGER_RUNS`` times, so that the libraries' handles,
  workspaces and algorithm choices exist;
* the model holds the submodules it held at the capture, the same
  objects in the same order, and each of their parameters and buffers
  has the storage it had then (a swapped submodule or a replaced storage
  drops the graphs; an in-place update keeps them, and the replay reads
  the new values);
* no other thread is replaying the model (one that finds the lock held
  runs eagerly).

Every other call runs the eager forward unchanged, and
:attr:`GraphCache.stats` counts it by reason. A replay copies the input
into the graph's own input, launches the graph on the current stream and
returns a clone of the graph's output: a later replay overwrites the
graph's buffers, never a tensor a caller holds. The same modules make the
same calls in the graph as in the eager forward (the casts of the float32
parameters included), so a replay's numbers are the eager forward's.

A model's graphs share one memory pool: replays are serial under the lock
and each output is cloned out before the next replay, so one graph's
buffers are never read after another's replay. ``Module._apply``
(``.to()``, ``.cuda()``, ``to_empty()``) drops them.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Callable, Optional

import torch
from torch import nn

from ..utils.tracing import trace_range

#: input signatures a model tracks; calls with further ones run eagerly
MAX_GRAPHS = 8
#: eager runs of a signature before it is captured
EAGER_RUNS = 2

_module = torch.nn.modules.module


class _Entry:
    """One input signature: eager runs so far, then the graph, its input
    and output, or the reason it stays eager."""

    __slots__ = ("runs", "graph", "input", "output", "eager")

    def __init__(self):
        self.runs = 0
        self.graph = self.input = self.output = self.eager = None


class GraphCache:
    """A model's CUDA graphs of its inference forward, one an input
    signature; call it as ``cache(model, forward, x)`` from the model's
    ``forward``, with ``forward`` the eager body."""

    def __init__(self):
        self.lock = threading.Lock()  # held by a capture or a replay
        self._count_lock = threading.Lock()  # eager counts, any thread
        #: captures, replays and eager calls by reason (``warmup``: the
        #: runs before a capture; ``cpu``, ``grad``, ``training``,
        #: ``autocast``, ``capturing``, ``compiling``, ``mode``,
        #: ``hooks``; ``cap``: past ``MAX_GRAPHS`` signatures;
        #: ``capture_failed``; ``busy``: another thread held the lock)
        self.stats = {"captures": 0, "replays": 0, "eager": Counter()}
        self.clear()

    def clear(self) -> None:
        """Drop every graph (the counts stay)."""
        self.entries = {}
        self.pool = self.side = None  # the graphs' memory and stream
        self.modules = None  # the model's modules at the first capture
        self.state = None  # their parameters' and buffers' data_ptrs
        self.stream = None  # the stream of the last replay

    def __len__(self) -> int:
        return sum(e.graph is not None for e in self.entries.values())

    def __reduce__(self):
        # a copied or unpickled model starts with no graphs
        return (GraphCache, ())

    def __call__(self, model: nn.Module, forward: Callable, x):
        reason = _ineligible(model, x)
        if reason is None:
            if self.lock.acquire(blocking=False):
                try:
                    out, reason = self._replay(model, forward, x)
                finally:
                    self.lock.release()
                if out is not None:
                    return out
            else:
                reason = "busy"
        with self._count_lock:
            self.stats["eager"][reason] += 1
        return forward(x)

    def _replay(self, model, forward, x):
        """(output, None) from a replay, or (None, reason) for an eager
        run. Called with the lock held."""
        modules, state = _walk(model)
        if state is None:
            return None, modules  # the reason
        if self.state is not None and (modules != self.modules
                                       or state != self.state):
            self.clear()
        key = (x.shape, x.stride(), x.dtype, x.device,
               torch.is_inference_mode_enabled(), _switches())
        entry = self.entries.get(key)
        if entry is None:
            if len(self.entries) >= MAX_GRAPHS:
                return None, "cap"
            entry = self.entries[key] = _Entry()
        if entry.eager is not None:
            return None, entry.eager
        if entry.graph is None:
            if entry.runs < EAGER_RUNS:
                entry.runs += 1
                return None, "warmup"
            reason = self._capture(forward, x, entry)
            if reason is not None:
                return None, reason
            self.modules, self.state = modules, state
        with trace_range("model.graph"), torch.cuda.device(x.device):
            stream = torch.cuda.current_stream()
            if self.stream is not None and stream != self.stream:
                stream.wait_stream(self.stream)  # the last replay's reads
            self.stream = stream
            entry.input.copy_(x)
            entry.graph.replay()
            out = entry.output.clone()
        self.stats["replays"] += 1
        return out, None

    def _capture(self, forward, x, entry) -> Optional[str]:
        """Capture ``forward`` for ``x``'s signature into ``entry``, after
        one eager run on the capture stream; the reason it stays eager
        if it cannot be captured."""
        with trace_range("model.graph_capture"), \
                torch.cuda.device(x.device):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
                self.side = torch.cuda.Stream()
            static_in = torch.empty_like(x)
            static_in.copy_(x)
            here, side = torch.cuda.current_stream(), self.side
            side.wait_stream(here)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(side):
                    forward(static_in)
                    graph.capture_begin(self.pool,
                                        capture_error_mode="thread_local")
                    try:
                        static_out = forward(static_in)
                    finally:
                        graph.capture_end()
            except RuntimeError:
                # a host sync or an unsupported call inside the forward
                entry.eager = "capture_failed"
                return entry.eager
            finally:
                here.wait_stream(side)
        entry.graph, entry.input, entry.output = graph, static_in, static_out
        self.stats["captures"] += 1
        return None


class GraphedModule(nn.Module):
    """A model whose CUDA inference forward :class:`GraphCache` may
    replay. A subclass defines ``_forward``, the eager body; ``forward``
    runs it, or replays it, inside the span ``model.forward``."""

    def __init__(self):
        super().__init__()
        self.graphs = GraphCache()

    @property
    def graph_stats(self) -> dict:
        return self.graphs.stats

    def forward(self, x):
        with trace_range("model.forward"):
            return self.graphs(self, self._forward, x)

    def _apply(self, fn, recurse=True):
        self.graphs.clear()
        return super()._apply(fn, recurse)


def _ineligible(model: nn.Module, x) -> Optional[str]:
    """Why this call runs the eager forward, or None where it may
    replay (the checks a call can make without touching the device)."""
    if (torch.compiler.is_compiling() or torch.compiler.is_exporting()
            or torch.jit.is_tracing()):
        return "compiling"
    if torch.is_grad_enabled():
        return "grad"
    if model.training:
        return "training"
    if torch.is_autocast_enabled("cuda") or torch.is_autocast_enabled("cpu"):
        return "autocast"
    if (type(x) is not torch.Tensor or torch._C._len_torch_dispatch_stack()
            or torch._C._len_torch_function_stack()):
        return "mode"
    if not x.is_cuda:
        return "cpu"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


def _switches() -> tuple:
    """The switches that cuBLAS and cuDNN read as the forward is captured:
    TF32 and reduced-precision reductions in matmuls, and cuDNN's
    algorithm choice."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    return (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_fp16_reduced_precision_reduction, cudnn.enabled,
            cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled())


def _walk(model: nn.Module):
    """One pass over the model's modules, breadth first from the model:
    ``(modules, ptrs)``, with ``ptrs`` the data_ptrs of their parameters
    and buffers; or ``(reason, None)`` where the forward may not be
    replayed: a submodule in training mode, or host work a replay would
    skip (a forward hook, a ``forward`` set on an instance). The checks
    of every call, so it reads the modules' dicts directly."""
    if _module._global_forward_hooks or _module._global_forward_pre_hooks:
        return "hooks", None
    modules, ptrs = [model], []
    for m in modules:  # grows as the walk goes
        d = m.__dict__
        if m is not model:  # the model's own hooks run outside forward
            if d["training"]:
                return "training", None
            if (d["_forward_hooks"] or d["_forward_pre_hooks"]
                    or "forward" in d):
                return "hooks", None
        if d["_parameters"]:
            ptrs += [t.data_ptr() for t in d["_parameters"].values()
                     if t is not None]
        if d["_buffers"]:
            ptrs += [t.data_ptr() for t in d["_buffers"].values()
                     if t is not None]
        if d["_modules"]:
            modules += [c for c in d["_modules"].values() if c is not None]
    return tuple(modules), tuple(ptrs)
