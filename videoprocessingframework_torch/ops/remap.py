"""Remap: per-pixel coordinate lookup (undistort / warp).

Counterpart of the JAX package's ``ops/remap.py``, the re-design of the
reference's RemapSurface (src/TC/src/Tasks.cpp:1505-1649, nppiRemap_8u_C3R
with float x/y maps uploaded once at construction): per frame, 4 gathers
plus a lerp for bilinear (one gather for nearest), batched over frames.
Plain PyTorch; no kernel of its own.

Coordinates outside the source are clamped to the border (NPP leaves such
pixels unwritten; with the undistort-style maps both behaviors agree).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.enums import PixelFormat
from ..core.surface import Surface
from ..utils.device import resolve_device
from ..utils.tracing import trace_range

F = PixelFormat


def remap_image(
    img: torch.Tensor,
    xmap: torch.Tensor,
    ymap: torch.Tensor,
    *,
    method: str = "bilinear",
) -> torch.Tensor:
    """img (N, H, W, C); xmap/ymap (H_out, W_out) float32 → (N, H_out, W_out, C)."""
    n, h, w, c = img.shape
    if method == "nearest":
        xi = torch.clamp(torch.round(xmap).to(torch.int64), 0, w - 1)
        yi = torch.clamp(torch.round(ymap).to(torch.int64), 0, h - 1)
        return img[:, yi, xi, :]
    x0 = torch.clamp(torch.floor(xmap).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(ymap).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = torch.clamp(xmap - x0.to(torch.float32), 0.0, 1.0)[None, :, :, None]
    fy = torch.clamp(ymap - y0.to(torch.float32), 0.0, 1.0)[None, :, :, None]
    p00 = img[:, y0, x0, :].to(torch.float32)
    p01 = img[:, y0, x1, :].to(torch.float32)
    p10 = img[:, y1, x0, :].to(torch.float32)
    p11 = img[:, y1, x1, :].to(torch.float32)
    top = p00 + (p01 - p00) * fx
    bot = p10 + (p11 - p10) * fx
    out = top + (bot - top) * fy
    if not torch.is_floating_point(img):
        info = torch.iinfo(img.dtype)
        out = torch.clamp(torch.round(out), info.min, info.max).to(img.dtype)
    else:
        out = out.to(img.dtype)
    return out


class SurfaceRemaper:
    """Packed RGB/BGR remap with fixed maps (PySurfaceRemaper analog,
    src/PyNvCodec/src/PySurfaceRemaper.cpp: packed 8-bit C3 only).

    The maps live on ``device`` (CUDA by default; pass ``"cpu"`` for the
    CPU), where the Surfaces to remap must be."""

    def __init__(
        self,
        xmap: np.ndarray,
        ymap: np.ndarray,
        fmt: PixelFormat = F.RGB,
        method: str = "bilinear",
        device=None,
    ):
        if xmap.shape != ymap.shape or xmap.ndim != 2:
            raise ValueError("x/y maps must be 2-D and equally shaped")
        if PixelFormat(fmt) not in (F.RGB, F.BGR):
            raise ValueError("remap supports packed RGB/BGR only")
        self.format = PixelFormat(fmt)
        self.method = method
        self.device = resolve_device(device)
        self.xmap = torch.as_tensor(np.asarray(xmap, np.float32),
                                    device=self.device)
        self.ymap = torch.as_tensor(np.asarray(ymap, np.float32),
                                    device=self.device)
        self.out_h, self.out_w = xmap.shape

    def run_planes(self, planes: Tuple[torch.Tensor, ...]) -> tuple:
        p = planes[0]
        img = p.reshape(*p.shape[:-1], p.shape[-1] // 3, 3)
        out = remap_image(img, self.xmap, self.ymap, method=self.method)
        return (out.reshape(*out.shape[:-2], out.shape[-2] * 3),)

    def run(self, src: Surface) -> Surface:
        if src.format != self.format:
            raise ValueError(
                f"Surface format {src.format.name} != remaper format "
                f"{self.format.name}"
            )
        planes = (src if src.is_on_device else src.to_device(self.device)).planes
        with trace_range("RemapSurface"):
            out = self.run_planes(tuple(p[None] for p in planes))
        return Surface(self.format, self.out_w, self.out_h, [out[0][0]])

    Execute = run
