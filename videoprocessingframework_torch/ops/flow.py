"""Dense optical flow on the device: pyramidal Lucas-Kanade and flow
warping — the counterpart of the JAX package's ``ops/flow.py``, which is
plain XLA there (no Pallas) and plain torch ops here.

* The pyramid is Gaussian blur + 2× decimation by separable convolutions
  (zero-padded by 2, so a level of n rows has ⌈n/2⌉ below it).
* A coarser flow is upsampled to the finer level's size by bilinear
  interpolation on half-pixel centres (``jax.image.resize(…, "linear")``;
  ``F.interpolate(align_corners=False)`` agrees with it, odd sizes
  included) and doubled, whatever the exact size ratio.
* Warping is four gathers + a lerp with border-clamped coordinates.
* The per-pixel 2×2 solve is closed form, its step clipped to ±window.

Tensors are computed on their own device; numpy inputs go to ``device``
(CUDA by default).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import as_tensor

__all__ = [
    "lucas_kanade_flow",
    "warp_image",
    "interpolate_midpoint",
    "mv_to_dense_flow",
]


def _as_f32_luma(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] (luma) or [B, H, W, C] (mean over C) → float32 in [0, 1]."""
    x = x.float()
    if x.dim() == 4:
        x = x.mean(dim=-1)
    return x * (1.0 / 255.0)


def _sep_conv(img: torch.Tensor, k: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """Separable 2-D convolution of [B, H, W] with the 1-D kernel k,
    zero-padded by len(k)//2 on each side."""
    pad = len(k) // 2
    x = img[:, None]
    x = F.conv2d(x, k.view(1, 1, -1, 1), stride=(stride, 1),
                 padding=(pad, 0))
    x = F.conv2d(x, k.view(1, 1, 1, -1), stride=(1, stride),
                 padding=(0, pad))
    return x[:, 0]


@lru_cache(maxsize=8)
def _gauss5(device: torch.device) -> torch.Tensor:
    """The 5-tap binomial kernel, uploaded once per device."""
    return torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=device) / 16.0


def _pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Gaussian blur + 2× decimation (classic image pyramid level)."""
    return _sep_conv(img, _gauss5(img.device), stride=2)


def _sample_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Per-batch per-pixel bilinear lookup: img [B, H, W]; x/y
    [B, Ho, Wo] absolute float32 source coordinates, clamped to the
    border → [B, Ho, Wo]."""
    b, h, w = img.shape
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    fx = x - x0.float()
    fy = y - y0.float()
    flat = img.reshape(b, h * w)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(b, -1)
        return torch.gather(flat, 1, idx).view_as(x)

    top = at(y0, x0) * (1.0 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1.0 - fx) + at(y1, x1) * fx
    return top * (1.0 - fy) + bot * fy


def _grid(b: int, h: int, w: int, device):
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return gx.expand(b, h, w), gy.expand(b, h, w)


def _grad(im):
    """Central differences with wrap-around (``jnp.roll``)."""
    ix = 0.5 * (torch.roll(im, -1, dims=2) - torch.roll(im, 1, dims=2))
    iy = 0.5 * (torch.roll(im, -1, dims=1) - torch.roll(im, 1, dims=1))
    return ix, iy


def _lk_refine(prev, nxt, flow, iters: int, window: int, eps: float):
    """``iters`` Lucas-Kanade updates of ``flow`` at one pyramid level."""
    b, h, w = prev.shape
    box = torch.full((window,), 1.0 / window, dtype=torch.float32,
                     device=prev.device)
    gx, gy = _grid(b, h, w, prev.device)
    ixp, iyp = _grad(prev)
    for _ in range(iters):
        warped = _sample_bilinear(nxt, gx + flow[..., 0], gy + flow[..., 1])
        # symmetric gradients (mean of prev and the warped next) halve
        # the linearisation bias on large shifts
        ixw, iyw = _grad(warped)
        ix, iy = 0.5 * (ixw + ixp), 0.5 * (iyw + iyp)
        it = warped - prev
        sxx = _sep_conv(ix * ix, box) + eps
        syy = _sep_conv(iy * iy, box) + eps
        sxy = _sep_conv(ix * iy, box)
        sxt = _sep_conv(ix * it, box)
        syt = _sep_conv(iy * it, box)
        det = sxx * syy - sxy * sxy
        du = (sxy * syt - syy * sxt) / det
        dv = (sxy * sxt - sxx * syt) / det
        # bound the step: ill-conditioned (flat) windows otherwise shoot
        # to values the next warp cannot recover from
        du = du.clamp(-float(window), float(window))
        dv = dv.clamp(-float(window), float(window))
        flow = flow + torch.stack([du, dv], dim=-1)
    return flow


def lucas_kanade_flow(prev, nxt, *, levels: int = 3, iters: int = 3,
                      window: int = 9, eps: float = 1e-4,
                      device=None) -> torch.Tensor:
    """Dense flow prev→next: ``prev(x) ≈ next(x + flow(x))``.

    prev/nxt: ``[B, H, W]`` luma (u8 or float, 0-255 scale) or
    ``[B, H, W, C]`` (channel-averaged). Returns ``[B, H, W, 2]`` float32
    — ``flow[..., 0]`` = dx, ``flow[..., 1]`` = dy, in pixels at full
    resolution. ``levels`` coarse-to-fine levels handle motion up to
    about ``window · 2**levels`` pixels; ``iters`` updates run per level.
    """
    prev = as_tensor(prev, device)
    p = _as_f32_luma(prev)
    n = _as_f32_luma(as_tensor(nxt, prev.device))
    if p.shape != n.shape:
        raise ValueError(f"frame shapes differ: {tuple(p.shape)} vs "
                         f"{tuple(n.shape)}")
    pyr = [(p, n)]
    for _ in range(levels - 1):
        p, n = pyr[-1]
        if min(p.shape[1] // 2, p.shape[2] // 2) < max(8, window):
            break  # don't shrink below the aggregation window
        pyr.append((_pyr_down(p), _pyr_down(n)))

    pc = pyr[-1][0]
    flow = torch.zeros(pc.shape + (2,), dtype=torch.float32,
                       device=pc.device)
    for lvl in range(len(pyr) - 1, -1, -1):
        pl, nl = pyr[lvl]
        if flow.shape[1:3] != pl.shape[1:3]:
            up = F.interpolate(flow.permute(0, 3, 1, 2),
                               size=pl.shape[1:3], mode="bilinear",
                               align_corners=False)
            flow = 2.0 * up.permute(0, 2, 3, 1)
        flow = _lk_refine(pl, nl, flow.contiguous(), iters, window, eps)
    return flow


def _like_input(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float result in the input's dtype; integer inputs are rounded and
    clipped."""
    if dtype.is_floating_point:
        return out.to(dtype)
    info = torch.iinfo(dtype)
    return torch.round(out).clamp(info.min, info.max).to(dtype)


def warp_image(img, flow, *, scale: float = 1.0,
               device=None) -> torch.Tensor:
    """Backward-warp ``img`` along ``scale * flow``.

    img: ``[B, H, W]`` or ``[B, H, W, C]``; flow: ``[B, H, W, 2]`` with the
    :func:`lucas_kanade_flow` convention, so ``warp_image(next, flow) ≈
    prev``. Output dtype matches the input (integer inputs are rounded
    and clipped).
    """
    img = as_tensor(img, device)
    flow = as_tensor(flow, img.device).float()
    chans = img.dim() == 4
    planes = img.movedim(-1, 0) if chans else img[None]
    gx, gy = _grid(img.shape[0], img.shape[1], img.shape[2], img.device)
    x = gx + scale * flow[..., 0]
    y = gy + scale * flow[..., 1]
    out = torch.stack([_sample_bilinear(p.float(), x, y) for p in planes])
    out = out.movedim(0, -1) if chans else out[0]
    return _like_input(out, img.dtype)


def interpolate_midpoint(prev, nxt, *, levels: int = 3, iters: int = 3,
                         window: int = 9, device=None) -> torch.Tensor:
    """The temporal midpoint frame between prev and next: dense flow both
    ways, each endpoint pulled halfway along its own field, blended.
    ``[B, H, W]`` or ``[B, H, W, C]`` in, the same shape and dtype out."""
    prev = as_tensor(prev, device)
    nxt = as_tensor(nxt, prev.device)
    kw = dict(levels=levels, iters=iters, window=window)
    fwd = lucas_kanade_flow(prev, nxt, **kw)
    bwd = lucas_kanade_flow(nxt, prev, **kw)
    a = warp_image(nxt.float(), fwd, scale=0.5)
    c = warp_image(prev.float(), bwd, scale=0.5)
    return _like_input(0.5 * (a + c), prev.dtype)


def mv_to_dense_flow(mvs: np.ndarray, width: int, height: int) -> np.ndarray:
    """Densify decoder motion vectors into an ``[H, W, 2]`` float32 field
    (host numpy, as in the JAX package).

    ``mvs`` is the structured array of ``GetMotionVectors()`` (fields
    ``source, w, h, src_x, src_y, dst_x, dst_y, motion_x, motion_y,
    motion_scale``). Each block around (dst_x, dst_y) is filled with its
    subpel motion in the prev→next convention of
    :func:`lucas_kanade_flow`: FFmpeg's ``src = dst + motion/scale`` points
    toward the reference, so past references (``source < 0``) are
    negated and future ones keep their sign.
    """
    flow = np.zeros((height, width, 2), np.float32)
    if mvs is None or len(mvs) == 0:
        return flow
    for mv in mvs:
        scale = float(mv["motion_scale"]) or 1.0
        dx = float(mv["motion_x"]) / scale
        dy = float(mv["motion_y"]) / scale
        if int(mv["source"]) < 0:
            dx, dy = -dx, -dy
        bw, bh = int(mv["w"]), int(mv["h"])
        x0 = int(mv["dst_x"]) - bw // 2
        y0 = int(mv["dst_y"]) - bh // 2
        x1 = max(min(x0 + bw, width), 0)
        y1 = max(min(y0 + bh, height), 0)
        x0 = min(max(x0, 0), width)
        y0 = min(max(y0, 0), height)
        flow[y0:y1, x0:x1, 0] = dx
        flow[y0:y1, x0:x1, 1] = dy
    return flow
