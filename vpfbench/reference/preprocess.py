"""Plain resize + colour conversion + normalisation of planar YUV420
frames, the reference for the port's ``FusedPipeline`` at
``output="normalized"``.

A frozen copy of the arithmetic, written out here so that the benchmark
holds it apart from the program: 3-lobe Lanczos matrices with
destination-centre mapping ``s = (i + 0.5)·scale − 0.5``, taps clamped at
the edges, each row normalised to sum 1, no antialias widening; the
chroma matrices fold adjacent column pairs of the luma ones (nearest 2×
chroma upsampling, then the resize); the BT.601 / BT.709 matrices at
MPEG (narrow) or JPEG (full) range; ``(clamp(rgb / 255, 0, 1) − mean) /
std``. Resize before colour conversion is exact: the colour matrix is
affine and every resize row sums to 1.

Matrices are built in float64 and used in ``dtype``: float32 (TF32 off)
is the reference, bfloat16 its lower-precision control.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

#: (Kr, Kb) of each colour space
KR_KB = {"bt601": (0.299, 0.114), "bt709": (0.2126, 0.0722)}


def lanczos_matrix(n_in: int, n_out: int, a: int = 3) -> np.ndarray:
    """(n_out, n_in) float64 Lanczos-``a`` resize matrix."""
    scale = n_in / n_out
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    m = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    for k in range(-a + 1, a + 1):
        tap = base + k
        x = np.abs(src - tap)
        w = np.where(x < a, np.sinc(x) * np.sinc(x / a), 0.0)
        np.add.at(m, (rows, np.clip(tap, 0, n_in - 1)), w)
    return m / m.sum(axis=1, keepdims=True)


def fold_pairs(m: np.ndarray) -> np.ndarray:
    """A luma resize matrix folded onto the half-width chroma grid."""
    o, n = m.shape
    return m.reshape(o, n // 2, 2).sum(-1)


def rgb_from_ycbcr(space: str, rng: str):
    """(M, off), float64: ``rgb = M @ (ycbcr − off)`` on 0..255 values."""
    kr, kb = KR_KB[space]
    kg = 1.0 - kr - kb
    m = np.array([
        [1.0, 0.0, 2.0 * (1.0 - kr)],
        [1.0, -2.0 * (1.0 - kb) * kb / kg, -2.0 * (1.0 - kr) * kr / kg],
        [1.0, 2.0 * (1.0 - kb), 0.0],
    ])
    off = np.array([0.0, 128.0, 128.0])
    if rng == "mpeg":
        m = m @ np.diag([255.0 / 219.0, 255.0 / 224.0, 255.0 / 224.0])
        off = np.array([16.0, 128.0, 128.0])
    elif rng != "jpeg":
        raise ValueError(f"unknown range {rng!r}")
    return m, off


def preprocess(y, u, v, out_h: int, out_w: int, space: str = "bt709",
               rng: str = "mpeg", mean=IMAGENET_MEAN, std=IMAGENET_STD,
               dtype=torch.float32) -> torch.Tensor:
    """(N, H, W), (N, H/2, W/2) ×2 uint8 planes → (N, out_h, out_w, 3)
    normalised RGB, computed in ``dtype`` and returned as float32."""
    h, w = y.shape[-2:]
    dev = y.device

    def mat(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    ry, cy = lanczos_matrix(h, out_h), lanczos_matrix(w, out_w)
    planes = [mat(ry) @ y.to(dtype) @ mat(cy).T]
    rc, cc = mat(fold_pairs(ry)), mat(fold_pairs(cy))
    planes += [rc @ p.to(dtype) @ cc.T for p in (u, v)]
    m, off = rgb_from_ycbcr(space, rng)
    ycc = torch.stack(planes, -1) - mat(off)
    rgb = ycc @ mat(m).T
    x = torch.clamp(rgb / 255.0, 0.0, 1.0)
    x = (x - mat(np.asarray(mean))) / mat(np.asarray(std))
    return x.float()
