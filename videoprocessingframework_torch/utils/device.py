"""Device selection shared by the package's entry points."""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, CUDA by default. Entry points never
    drop to the CPU silently: without a GPU they raise unless the caller
    asked for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def is_dtensor(x) -> bool:
    """``x`` is a ``torch.distributed`` ``DTensor`` (checked without
    importing ``torch.distributed.tensor``: without it, nothing is)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays on its own device; anything else (numpy, lists)
    goes to ``device`` (CUDA by default)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    # torch tensors are writable and take no negative strides: copy
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy()
    return torch.as_tensor(a, device=resolve_device(device))


def to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or numpy data) on ``device``. Host data goes to a
    CUDA device by a pinned non-blocking copy, so the host does not wait
    for the device's queued work."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def check_f32_matmul(x: torch.Tensor, what: str) -> None:
    """``what`` computes in full float32: refuse a CUDA tensor while TF32
    matmuls are allowed."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{what} computes in full float32: turn TF32 matmul off "
            "(torch.backends.cuda.matmul.allow_tf32 = False)"
        )


def upload(host: Sequence[torch.Tensor], device: torch.device,
           stream: Optional["torch.cuda.Stream"]) -> tuple:
    """Host tensors → ``device`` for the current stream: ``(tensors,
    uploaded)``.

    On CUDA (``stream`` a side stream) each tensor is one non-blocking
    copy on ``stream``; the current stream waits on the event
    ``uploaded``, which is also the host tensors' recycle barrier: they
    may be written again once it has completed. Pinned host tensors make
    the copies DMA straight from them. Without a stream (the CPU) the
    tensors are cloned, since a ring of ``from_numpy`` views would alias
    them, and ``uploaded`` is None.
    """
    if stream is None:
        return [h.clone() for h in host], None
    cur = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        staged = [torch.empty(h.shape, dtype=h.dtype, device=device)
                  for h in host]
        for dst, src in zip(staged, host):
            dst.copy_(src, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(stream)
    cur.wait_event(uploaded)
    for t in staged:
        t.record_stream(cur)
    return staged, uploaded
