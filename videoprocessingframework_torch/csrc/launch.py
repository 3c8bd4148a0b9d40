"""Launch the package's hand-written CUDA kernels and count the launches.

:func:`launch` calls a kernel's C entry point ``vpf_<name>`` (bound by
:func:`.build.load_kernels`) with the current stream of a device, raises
where the launch failed, and counts it under ``<name>``. :data:`LAUNCHES`
counts every launch in the process since the last :func:`reset_launches`
(a run shows it went through a kernel by this count); :func:`counting`
counts those its own context makes (this thread's, or this asyncio
task's), which is what a model reports of one call while others run
beside it. The wrappers (``ops/fused_cuda.py``, ``ops/csc_cuda.py``,
``models/layers_cuda.py``) keep their checks, plans and argument lists.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Dict, Iterator, Tuple

import torch

from . import build

#: kernel launches since the last reset, by kernel (``fused_resize_csc_direct``
#: is the first version of the fused kernel, kept as its baseline)
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("fused_resize_csc", "fused_resize_csc_direct", "csc_rgb_planar",
     "layer_norm", "rope2d"), 0)

#: the counts of the open :func:`counting` contexts, innermost last
_COUNTING: contextvars.ContextVar[Tuple[Dict[str, int], ...]] = \
    contextvars.ContextVar("kernel_launch_counting", default=())


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, int]]:
    """Yield a dict of launches by kernel that counts the ones made in
    this context (its thread, or its asyncio task) until it closes; a
    context opened inside it counts into both."""
    counts = dict.fromkeys(LAUNCHES, 0)
    token = _COUNTING.set(_COUNTING.get() + (counts,))
    try:
        yield counts
    finally:
        _COUNTING.reset(token)


def _count(name: str) -> None:
    LAUNCHES[name] += 1
    for counts in _COUNTING.get():
        counts[name] += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """A tensor's device address as a C pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def launch(name: str, device: torch.device, *args) -> None:
    """Launch ``vpf_<name>(*args, stream)`` on ``device``'s current
    stream and count it; a nonzero CUDA error raises."""
    lib = build.load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"vpf_{name}")(*args, ctypes.c_void_p(stream))
    if err != 0:
        text = lib.vpf_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({text})")
    _count(name)
