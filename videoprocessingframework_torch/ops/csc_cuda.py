"""Full-resolution NV12 / planar YUV420 u8 → planar RGB u8 (no resize):
the CUDA kernel's wrappers, their plain PyTorch versions and the gate.

The kernel (csrc/csc_rgb_planar.cu) replaces the TPU's Pallas kernel
``videoprocessingframework_tpu/ops/pallas_kernels.py:nv12_to_rgb_planar_pallas``
(and ``yuv420_to_rgb_planar_pallas``, which reached it through an XLA U/V
interleave; here planar U and V are read directly):

    out[b, c] = clip(rint((m[c,0]·y' + m[c,1]·u') + m[c,2]·v'), 0, 255)

with y' = y − off0 and u', v' the 2×2-replicated chroma minus off1, off2,
all float32, each product and sum rounded on its own. The kernel and the
plain version compute it in the same order, so they agree exactly.

Dispatch: a CPU tensor takes the plain version (``*_ref``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..csrc.launch import launch, ptr
from . import colorspace as cs
from .colorspace import f32


def csc_cuda_supported(h: int, w: int) -> bool:
    """Gate of the CUDA kernel: an even luma size (4:2:0 chroma). The
    TPU's H%32 / W%128 tiling rule does not apply on this card."""
    return h >= 2 and w >= 2 and h % 2 == 0 and w % 2 == 0


def _check(y, chroma, step):
    if y.dim() != 3:
        raise ValueError(f"expected batched (B, H, W) planes, got {y.shape}")
    b, h, w = y.shape
    for p in (y,) + tuple(chroma):
        if p.dtype != torch.uint8:
            raise ValueError(f"planes must be uint8, got {p.dtype}")
        if p.device != y.device:
            raise ValueError("planes must share one device")
    if not csc_cuda_supported(h, w):
        raise ValueError(f"4:2:0 needs an even frame size, got {h}x{w}")
    want = (b, h // 2, (w // 2) * step)
    for p in chroma:
        if tuple(p.shape) != want:
            raise ValueError(f"chroma plane {tuple(p.shape)} != {want}")


# ---- plain PyTorch version -----------------------------------------------------


def _up2(c: torch.Tensor) -> torch.Tensor:
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _plain(y, u, v, space, rng, swap):
    m, off = cs.rgb_from_ycbcr_f32(space, rng, swap)
    f = torch.float32
    yf = y.to(f) - f32(off[0])
    uf = _up2(u).to(f) - f32(off[1])
    vf = _up2(v).to(f) - f32(off[2])
    chans = [
        torch.clamp(torch.round(
            f32(m[i, 0]) * yf + f32(m[i, 1]) * uf + f32(m[i, 2]) * vf
        ), 0.0, 255.0).to(torch.uint8)
        for i in range(3)
    ]
    return torch.stack(chans, dim=1)


def nv12_to_rgb_planar_ref(y, uv, *, space=ColorSpace.BT_709,
                           rng=ColorRange.MPEG, swap: bool = False):
    """Plain version of the kernel on NV12: y (B,H,W) u8 + interleaved uv
    (B,H/2,W) u8 → (B,3,H,W) u8."""
    _check(y, (uv,), 2)
    return _plain(y, uv[..., 0::2], uv[..., 1::2], space, rng, swap)


def yuv420_to_rgb_planar_ref(y, u, v, *, space=ColorSpace.BT_709,
                             rng=ColorRange.MPEG, swap: bool = False):
    """Plain version of the kernel on planar YUV420: y (B,H,W) + u, v
    (B,H/2,W/2) u8 → (B,3,H,W) u8."""
    _check(y, (u, v), 1)
    return _plain(y, u, v, space, rng, swap)


# ---- the kernel ------------------------------------------------------------------


def _aligned(n: int, *ints: int) -> bool:
    return all(i % n == 0 for i in ints)


def _vec(y, c_ptrs, c_strides, step) -> int:
    """Luma columns a thread takes: the widest of 8, 4, 2 that the width
    and every plane's base and strides allow as one load (luma and NV12
    chroma ``vec`` bytes, planar chroma ``vec / 2``). Raises where not
    even 2 is possible."""
    w = y.shape[-1]
    luma = (y.data_ptr(), y.stride(0), y.stride(1))
    for vec in (8, 4, 2):
        cvec = vec if step == 2 else vec // 2
        if (w % vec == 0 and _aligned(vec, *luma)
                and _aligned(cvec, *c_ptrs, *c_strides[:2])):
            return vec
    raise ValueError(
        "plane base pointers and row strides must be 2-byte aligned "
        "(even) for the CUDA kernel"
    )


def _launch(y, c_ptrs, c_strides, step, *, space, rng, swap):
    """Launch the kernel on the current stream; chroma as base pointers
    (NV12: one, the interleaved plane) with (batch, row) strides in
    bytes."""
    if not y.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {y.device}")
    if y.stride(-1) != 1:
        raise ValueError("planes must be contiguous along their rows")
    b, h, w = y.shape
    vec = _vec(y, c_ptrs, c_strides, step)
    m, off = cs.rgb_from_ycbcr_f32(space, rng, swap)
    csc = (ctypes.c_float * 12)(*np.concatenate([m.ravel(), off]).tolist())
    out = torch.empty((b, 3, h, w), dtype=torch.uint8, device=y.device)
    if b == 0:
        return out
    launch("csc_rgb_planar", y.device, ptr(y), ctypes.c_void_p(c_ptrs[0]),
           ctypes.c_void_p(c_ptrs[-1]), step, b, h, w, y.stride(0),
           y.stride(1), c_strides[0], c_strides[1], ptr(out), vec, csc)
    return out


def nv12_to_rgb_planar(y, uv, *, space=ColorSpace.BT_709,
                       rng=ColorRange.MPEG, swap: bool = False):
    """y (B,H,W) u8 + interleaved uv (B,H/2,W) u8 → (B,3,H,W) u8 planar
    RGB (BGR when ``swap``). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if y.device.type == "cpu":
        return nv12_to_rgb_planar_ref(y, uv, space=space, rng=rng, swap=swap)
    _check(y, (uv,), 2)
    if uv.stride(-1) != 1:
        raise ValueError("planes must be contiguous along their rows")
    return _launch(y, (uv.data_ptr(),), uv.stride(), 2, space=space,
                   rng=rng, swap=swap)


def yuv420_to_rgb_planar(y, u, v, *, space=ColorSpace.BT_709,
                         rng=ColorRange.MPEG, swap: bool = False):
    """Planar y (B,H,W) + u, v (B,H/2,W/2) u8 → (B,3,H,W) u8 planar RGB,
    reading U and V directly. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if y.device.type == "cpu":
        return yuv420_to_rgb_planar_ref(y, u, v, space=space, rng=rng,
                                        swap=swap)
    _check(y, (u, v), 1)
    if u.stride() != v.stride():
        raise ValueError("u and v planes must share one layout")
    if u.stride(-1) != 1:
        raise ValueError("planes must be contiguous along their rows")
    return _launch(y, (u.data_ptr(), v.data_ptr()), u.stride(), 1,
                   space=space, rng=rng, swap=swap)
