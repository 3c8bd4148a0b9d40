"""Separable resize matrices (numpy float64 math, float32 result).

A resize is ``out = R @ img @ Cᵀ`` with R (H_out×H_in) and C (W_out×W_in)
precomputed interpolation matrices. The fused device path
(ops/fused.py, csrc/fused_resize_csc.cu) consumes them either densely
(the torch path) or as compact per-output tap tables (the CUDA kernel).
Supported filters:

* ``lanczos``  — 3-lobe Lanczos (fixed 6-tap kernel, no antialiasing
  scaling — NPP's plain Lanczos interpolation mode)
* ``bilinear`` — 2-tap triangle
* ``nearest``  — 1-tap

Matrices use dst-pixel-center mapping ``s = (i + 0.5)·scale − 0.5`` with
edge clamping and per-row weight normalization.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

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
