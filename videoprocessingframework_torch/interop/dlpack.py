"""Zero-copy tensor interop: Surface ↔ torch.Tensor.

Replaces the reference's PytorchNvCodec extension
(src/PytorchNvCodec/src/PytorchNvCodec.cpp:36-139 —
makefromDevicePtrUint8 / TensorToDptr), which does a device-to-device
copy per frame. A device Surface's planes already ARE ``torch.Tensor``s,
so handing one to a model is free: no copy and no DLPack round trip.
Tensors leave for other frameworks through ``torch.utils.dlpack`` or
``__cuda_array_interface__`` on the plane itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.enums import PixelFormat
from ..core.surface import Surface, split_frame
from ..utils.device import resolve_device


def surface_to_torch(surface: Surface, plane: int = 0) -> torch.Tensor:
    """The plane's tensor itself for a device Surface (zero copy: a write
    into it is a write into the Surface). A host Surface's numpy plane is
    wrapped with ``torch.from_numpy``, which shares its memory."""
    arr = surface.planes[plane]
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr))
    return arr


def surface_planes(surface: Surface, device=None) -> tuple:
    """Every plane as a tensor: a device Surface's own tensors, or a host
    Surface's planes copied to ``device`` (CUDA by default)."""
    s = surface if surface.is_on_device else surface.to_device(
        resolve_device(device))
    return tuple(s.planes)


def torch_to_surface(
    tensor: torch.Tensor, fmt: PixelFormat, width: int, height: int,
    device=None,
) -> Surface:
    """A packed frame tensor (any shape; its bytes in the layout of
    :meth:`Surface.download`) → Surface.

    With ``device=None`` the Surface's planes are views of ``tensor`` on
    its own device (no copy; a non-contiguous tensor is made contiguous
    first); with a ``device`` they are copied there."""
    flat = tensor.detach().contiguous().reshape(-1).view(torch.uint8)
    if device is not None:
        flat = flat.to(resolve_device(device), copy=True)
    return Surface(fmt, width, height, split_frame(flat, fmt, width, height))
