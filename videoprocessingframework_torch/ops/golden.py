"""Golden (numpy float64) reference implementations of every conversion.

These define the framework's numeric ground truth: ITU matrices from
ops/colorspace.py, nearest (2×2 replicate) chroma upsampling, 2×2 mean
chroma downsampling, round-half-to-even, saturate to the output type.
Device kernels are tested against these to ≤1 ULP per 8-bit channel.
Used by tests only — never on the hot path.
"""

from __future__ import annotations

import numpy as np

from ..core.enums import ColorRange, ColorSpace
from . import colorspace as cs


def _round_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def upsample_chroma_420(c: np.ndarray) -> np.ndarray:
    """(H/2, W/2) → (H, W) by 2×2 replication (NPP nearest semantics)."""
    return np.repeat(np.repeat(c, 2, axis=-2), 2, axis=-1)


def downsample_chroma_420(c: np.ndarray) -> np.ndarray:
    """(H, W) float → (H/2, W/2) by 2×2 mean."""
    h, w = c.shape[-2:]
    return c.reshape(*c.shape[:-2], h // 2, 2, w // 2, 2).mean(axis=(-3, -1))


def ycbcr_to_rgb(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
    space: ColorSpace, rng: ColorRange,
) -> np.ndarray:
    """Full-resolution Y/Cb/Cr (H, W) uint8 → (H, W, 3) uint8 RGB."""
    m, off = cs.rgb_from_ycbcr_matrix(space, rng)
    ycc = np.stack([y, cb, cr], axis=-1).astype(np.float64) - off
    rgb = ycc @ m.T
    return _round_u8(rgb)


def rgb_to_ycbcr(
    rgb: np.ndarray, space: ColorSpace, rng: ColorRange
) -> np.ndarray:
    """(H, W, 3) uint8 RGB → (H, W, 3) float64 YCbCr (unrounded, so 4:2:0
    downsampling can average before quantization)."""
    m, off = cs.ycbcr_from_rgb_matrix(space, rng)
    return rgb.astype(np.float64) @ m.T + off


def nv12_to_rgb(
    y: np.ndarray, uv: np.ndarray, space: ColorSpace, rng: ColorRange
) -> np.ndarray:
    """y (H, W), uv (H/2, W) interleaved → (H, W, 3) RGB."""
    h2, w = uv.shape
    u = upsample_chroma_420(uv.reshape(h2, w // 2, 2)[..., 0])
    v = upsample_chroma_420(uv.reshape(h2, w // 2, 2)[..., 1])
    return ycbcr_to_rgb(y, u, v, space, rng)


def yuv420_to_rgb(
    y: np.ndarray, u: np.ndarray, v: np.ndarray,
    space: ColorSpace, rng: ColorRange,
) -> np.ndarray:
    return ycbcr_to_rgb(y, upsample_chroma_420(u), upsample_chroma_420(v), space, rng)


def rgb_to_yuv420(
    rgb: np.ndarray, space: ColorSpace, rng: ColorRange
):
    ycc = rgb_to_ycbcr(rgb, space, rng)
    y = _round_u8(ycc[..., 0])
    u = _round_u8(downsample_chroma_420(ycc[..., 1]))
    v = _round_u8(downsample_chroma_420(ycc[..., 2]))
    return y, u, v


def rgb_to_yuv444(rgb: np.ndarray, space: ColorSpace, rng: ColorRange):
    ycc = rgb_to_ycbcr(rgb, space, rng)
    return _round_u8(ycc[..., 0]), _round_u8(ycc[..., 1]), _round_u8(ycc[..., 2])


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """NPP RGBToGray semantics: 0.299/0.587/0.114, full range."""
    return _round_u8(rgb.astype(np.float64) @ cs.GRAY_WEIGHTS)


def p16_to_8bit(plane: np.ndarray) -> np.ndarray:
    """MSB-aligned 16-bit → 8-bit: round(v / 256), saturate
    (reference p16_nv12 impl: DivC by 256 + 16u→8u convert)."""
    return np.clip(np.rint(plane.astype(np.float64) / 256.0), 0, 255).astype(
        np.uint8
    )


def rgb8_to_rgb32f(rgb: np.ndarray) -> np.ndarray:
    """uint8 → float32 scaled to [0, 1] (nppiScale_8u32f semantics)."""
    return (rgb.astype(np.float32) / 255.0).astype(np.float32)
