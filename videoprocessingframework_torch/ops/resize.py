"""Separable resize: the matrices (numpy float64 math, float32 result),
the plane resizer and ``SurfaceResizer``.

A resize is ``out = R @ img @ Cᵀ`` with R (H_out×H_in) and C (W_out×W_in)
precomputed interpolation matrices. The fused device path
(ops/fused.py, csrc/fused_resize_csc.cu) consumes them either densely
(the torch path) or as compact per-output tap tables (the CUDA kernel);
:func:`resize_plane` applies them as two float32 ``torch.matmul``s (plain
large products, as the JAX package left them to XLA; no kernel of its
own). Supported filters:

* ``lanczos``  — 3-lobe Lanczos (fixed 6-tap kernel, no antialiasing
  scaling — NPP's plain Lanczos interpolation mode)
* ``bilinear`` — 2-tap triangle
* ``nearest``  — 1-tap

Matrices use dst-pixel-center mapping ``s = (i + 0.5)·scale − 0.5`` with
edge clamping and per-row weight normalization.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..core import geometry
from ..core.enums import PixelFormat
from ..core.surface import Surface
from ..utils.tracing import trace_range

SUPPORTED = ("lanczos", "bilinear", "nearest")


def _lanczos(x: np.ndarray, a: int = 3) -> np.ndarray:
    x = np.abs(x)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(x < a, out, 0.0)


@lru_cache(maxsize=256)
def resize_matrix(
    n_in: int, n_out: int, method: str = "lanczos", window=None
) -> np.ndarray:
    """(n_out, n_in) float32 interpolation matrix, rows sum to 1.

    ``window=(start, length)`` resamples only that source span (the NPP
    ROI-resize analog): output pixel centers map into
    [start, start+length) instead of the full axis. Taps falling just
    outside the window use the REAL neighboring pixels; taps beyond the
    frame clamp to the edge as usual. ``window=None`` is the full axis.
    """
    if method not in SUPPORTED:
        raise ValueError(f"unknown resize method {method!r}")
    if window is None:
        start, length = 0.0, float(n_in)
    else:
        start, length = float(window[0]), float(window[1])
        if not (length > 0 and 0.0 <= start and start + length <= n_in):
            raise ValueError(
                f"window {window} outside source axis of {n_in}"
            )
    scale = length / n_out
    dst = np.arange(n_out, dtype=np.float64)
    src = start + (dst + 0.5) * scale - 0.5
    m = np.zeros((n_out, n_in), dtype=np.float64)
    if method == "nearest":
        idx = np.clip(np.floor(src + 0.5).astype(np.int64), 0, n_in - 1)
        m[np.arange(n_out), idx] = 1.0
    else:
        a = 3 if method == "lanczos" else 1
        base = np.floor(src).astype(np.int64)
        for k in range(-a + 1, a + 1):
            tap = base + k
            w = (
                _lanczos(src - tap, a)
                if method == "lanczos"
                else np.maximum(0.0, 1.0 - np.abs(src - tap))
            )
            np.add.at(m, (np.arange(n_out), np.clip(tap, 0, n_in - 1)), w)
        m /= m.sum(axis=1, keepdims=True)
    return m.astype(np.float32)


def chroma_collapse(mat: np.ndarray) -> np.ndarray:
    """Fold a full-res resize matrix onto the half-res chroma grid.

    With nearest (2× replicate) chroma upsampling, c_full[i] = c[i // 2],
    so  Σ_i M[o, i]·c_full[i]  ==  Σ_j (M[o, 2j] + M[o, 2j+1])·c[j]:
    summing adjacent column pairs gives a half-size matrix whose result
    equals upsample-then-resize without materializing full-res chroma.
    """
    o, n = mat.shape
    return mat.reshape(o, n // 2, 2).sum(-1)


F = PixelFormat


def resize_plane(
    img: torch.Tensor,
    *,
    h_out: int,
    w_out: int,
    method: str = "lanczos",
    round_u8: bool = True,
) -> torch.Tensor:
    """Resize (..., H, W) or (..., H, W, C) tensors via two float32
    matmuls (TF32 must be off on CUDA: the products are full float32)."""
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("resize_plane is full float32: turn TF32 matmul "
                           "off")
    has_c = img.dim() >= 3 and img.shape[-1] <= 4 and img.dim() > 2
    # canonicalize to (..., C, H, W)
    x = torch.movedim(img if has_c else img[..., None], -1, -3)
    h_in, w_in = x.shape[-2], x.shape[-1]
    r = torch.from_numpy(resize_matrix(h_in, h_out, method)).to(img.device)
    c = torch.from_numpy(resize_matrix(w_in, w_out, method)).to(img.device)
    y = torch.matmul(torch.matmul(r, x.to(torch.float32)), c.T)
    if not torch.is_floating_point(img):
        if round_u8:
            info = torch.iinfo(img.dtype)
            y = torch.clamp(torch.round(y), info.min, info.max).to(img.dtype)
        # else: caller wants the float32 intermediate (fusion)
    else:
        y = y.to(img.dtype)
    y = torch.movedim(y, -3, -1)
    return y if has_c else y[..., 0]


def resize_packed3(img: torch.Tensor, h_out: int, w_out: int,
                   method="lanczos"):
    """(..., H, 3W) interleaved → (..., h_out, 3·w_out)."""
    x = img.reshape(*img.shape[:-1], img.shape[-1] // 3, 3)
    y = resize_plane(x, h_out=h_out, w_out=w_out, method=method)
    return y.reshape(*y.shape[:-2], y.shape[-2] * 3)


class SurfaceResizer:
    """Fixed-target resizer over Surfaces (PySurfaceResizer analog,
    src/PyNvCodec/src/PySurfaceResizer.cpp). Handles every format family
    the reference does: packed 8-bit C3 (RGB/BGR), planar 8-bit per plane
    (YUV420/YCbCr/YUV444/RGB_PLANAR/Y/NV12), packed/planar float32. It
    runs on the device the planes are on; a host Surface is uploaded to
    the default device (CUDA) first."""

    def __init__(self, width: int, height: int, fmt: PixelFormat,
                 method: str = "lanczos"):
        self.width = width
        self.height = height
        self.format = PixelFormat(fmt)
        self.method = method
        if self.format not in geometry.PLANE_SPECS:
            raise ValueError(f"unsupported format {fmt}")

    def run_planes(self, planes: Tuple[torch.Tensor, ...]) -> tuple:
        """Resize batched plane tensors (leading N) to the target size."""
        fmt = self.format
        specs = geometry.PLANE_SPECS[fmt]
        out = []
        for spec, p in zip(specs, planes):
            th = (self.height * spec.height_num) // spec.height_den
            tw = (self.width * spec.width_num) // spec.width_den
            if fmt in (F.RGB, F.BGR, F.RGB_32F):
                out.append(resize_packed3(p, th, tw, self.method))
            elif fmt in (F.NV12, F.NV12_PLANAR, F.P10, F.P12) and spec.channels == 2:
                # interleaved UV: resize U and V separately
                s = p.reshape(*p.shape[:-1], p.shape[-1] // 2, 2)
                y = resize_plane(s, h_out=th, w_out=tw, method=self.method)
                out.append(y.reshape(*y.shape[:-2], y.shape[-2] * 2))
            elif fmt in (F.RGB_PLANAR, F.RGB_32F_PLANAR):
                n, h3, w = p.shape
                x = p.reshape(n, 3, h3 // 3, w)
                y = resize_plane(
                    x, h_out=self.height, w_out=tw, method=self.method
                )
                out.append(y.reshape(n, 3 * self.height, tw))
            else:
                out.append(resize_plane(p, h_out=th, w_out=tw, method=self.method))
        return tuple(out)

    def run(self, src: Surface) -> Surface:
        if src.format != self.format:
            raise ValueError(
                f"Surface format {src.format.name} != resizer format "
                f"{self.format.name}"
            )
        batched = tuple(p[None] for p in src.to_device().planes)
        with trace_range("ResizeSurface"):
            out = self.run_planes(batched)
        return Surface(self.format, self.width, self.height, [p[0] for p in out])

    Execute = run
