"""The benchmark's yardstick: the card's published peaks and the least
work of the pre-processing, counted from the shapes.

Peaks are NVIDIA's data sheets, dense rates without sparsity, at the full
power limit (the run prints the card's limit beside every number).
"""

from __future__ import annotations

import numpy as np

from .reference.preprocess import fold_pairs, lanczos_matrix

#: (name fragment, {bf16 FLOP/s, fp32 FLOP/s, memory bytes/s}); the first
#: fragment that the device's name holds wins
PEAKS = (
    ("H200", {"bf16": 989e12, "fp32": 67e12, "memory": 4.8e12}),
    ("H100 NVL", {"bf16": 835e12, "fp32": 60e12, "memory": 3.9e12}),
    ("H100 PCIe", {"bf16": 756e12, "fp32": 51e12, "memory": 2.0e12}),
    ("H100", {"bf16": 989e12, "fp32": 67e12, "memory": 3.35e12}),
)


def peaks(device_name: str) -> dict:
    for fragment, rates in PEAKS:
        if fragment in device_name:
            return rates
    raise ValueError(f"no published peaks for {device_name!r}")


def _taps(m: np.ndarray) -> int:
    return int((m != 0).sum(1).max())


def preprocess_work(n: int, height: int, width: int, out_h: int,
                    out_w: int) -> tuple:
    """(bytes, FLOPs) of YUV420 ``height``×``width`` → ``out_h``×``out_w``
    normalised float32 RGB for ``n`` frames: each input byte read once and
    each output byte written once; per output pixel and plane, the
    columns' taps summed down the rows' taps and then across (the
    separable Lanczos), and the 3×3 colour matrix."""
    nbytes = n * (height * width + 2 * (height // 2) * (width // 2)) \
        + n * out_h * out_w * 3 * 4
    ry, cy = lanczos_matrix(height, out_h), lanczos_matrix(width, out_w)
    macs = _taps(cy) * (_taps(ry) + 1) \
        + 2 * _taps(fold_pairs(cy)) * (_taps(fold_pairs(ry)) + 1) + 9
    return nbytes, 2.0 * n * out_h * out_w * macs


def preprocess_least_s(n, height, width, out_h, out_w, rates) -> float:
    """The least time of that work on the card: bytes over the memory
    rate or FLOPs over the float32 rate, whichever is longer."""
    nbytes, flops = preprocess_work(n, height, width, out_h, out_w)
    return max(nbytes / rates["memory"], flops / rates["fp32"])
