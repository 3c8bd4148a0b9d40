"""Video stabilisation: flow-based global motion + a smoothed camera path
— the counterpart of the JAX package's ``ops/stabilize.py``.

1. dense flow between consecutive frames (:mod:`.flow`, on the device);
2. a robust global translation per pair: the median over the interior
   (the mean of the two middle values for an even count, as
   ``jnp.median``; ``torch.median`` would return the lower one);
3. the cumulative camera path, low-passed with a Gaussian on the host
   (numpy: an [N, 2] path);
4. each frame warped by (path − smoothed path) on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import as_tensor, resolve_device
from .flow import lucas_kanade_flow, warp_image

__all__ = ["global_translations", "median", "smooth_path", "stabilize_clip"]


def median(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 1, averaging the two middle values of an even
    count."""
    s = torch.sort(x, dim=1).values
    n = x.shape[1]
    return 0.5 * (s[:, (n - 1) // 2] + s[:, n // 2])


def global_translations(frames, *, levels: int = 3, iters: int = 3,
                        window: int = 9, margin: int = 16,
                        device=None) -> torch.Tensor:
    """Per-pair robust global motion for [N, H, W] consecutive luma frames
    → [N-1, 2] float32 (dx, dy): content at p in frame i appears at
    p + (dx, dy) in frame i+1 (flow convention ``prev(x) ≈ next(x +
    flow)``). All N−1 flows solve as one batched pyramid; the median over
    the interior (``margin`` excluded: the warp clamps the border) is the
    estimate."""
    frames = as_tensor(frames, device)
    h, w = frames.shape[-2], frames.shape[-1]
    if h <= 2 * margin or w <= 2 * margin:
        raise ValueError(
            f"frames {h}x{w} leave no interior at margin={margin} "
            f"(need H > {2 * margin} and W > {2 * margin}); pass a "
            "smaller margin= for tiny frames"
        )
    flow = lucas_kanade_flow(frames[:-1], frames[1:], levels=levels,
                             iters=iters, window=window)
    core = flow[:, margin:-margin, margin:-margin, :]
    return median(core.reshape(core.shape[0], -1, 2))


def smooth_path(path: np.ndarray, sigma: float = 5.0) -> np.ndarray:
    """Gaussian low-pass of an [N, 2] cumulative trajectory (host; odd
    reflection at the ends, so a steady pan passes through unchanged)."""
    r = max(1, int(3 * sigma))
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    padded = np.pad(path.astype(np.float64), ((r, r), (0, 0)),
                    mode="reflect", reflect_type="odd")
    out = np.stack(
        [np.convolve(padded[:, i], k, mode="valid") for i in range(2)], axis=1
    )
    return out.astype(np.float32)


def stabilize_clip(frames: np.ndarray, *, sigma: float = 5.0,
                   levels: int = 3, iters: int = 3,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Stabilise an [N, H, W] (or [N, H, W, C]) numpy clip, computing on
    ``device`` (CUDA by default).

    Returns ``(stabilized, correction)``: ``correction`` is the [N, 2]
    per-frame (dx, dy) applied. Smooth pans survive; jitter with a period
    ≲ ``sigma`` frames is removed; exposed borders are clamp-padded.
    """
    frames = np.asarray(frames)
    dev = resolve_device(device)
    luma = frames if frames.ndim == 3 else frames.mean(axis=-1)
    steps = global_translations(as_tensor(luma, dev), levels=levels,
                                iters=iters).cpu().numpy()
    # frame i's content sits at −step in frame i+1: the camera moved by
    # +step; integrate to a path
    path = np.concatenate(
        [np.zeros((1, 2), np.float32), np.cumsum(-steps, axis=0)]
    )
    correction = smooth_path(path, sigma=sigma) - path
    # moving the camera by `correction` shifts content by −correction:
    # out(x) = img(x + correction), a backward-warp field constant per frame
    flow = as_tensor(correction.astype(np.float32), dev)
    flow = flow[:, None, None, :].expand(
        frames.shape[0], frames.shape[1], frames.shape[2], 2)
    out = warp_image(as_tensor(frames, dev), flow)
    return out.cpu().numpy(), correction.astype(np.float32)
