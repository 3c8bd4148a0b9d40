"""Device selection shared by the package's entry points."""

from __future__ import annotations

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
