"""Video quality metrics: PSNR, SSIM and MS-SSIM as batched device ops —
the counterpart of the JAX package's ``ops/metrics.py`` (jitted ``jnp``
code there, plain torch ops here).

Tensors are computed on their own device; numpy inputs go to ``device``
(CUDA by default).
"""

from __future__ import annotations

import math

import torch

from ..utils.device import as_tensor

__all__ = ["psnr", "ssim", "ms_ssim"]


def psnr(a, b, *, max_val: float = 255.0, device=None) -> torch.Tensor:
    """PSNR per batch element over all remaining axes. (N, …) → (N,);
    ``inf`` where the two are equal."""
    a = as_tensor(a, device)
    a, b = a.float(), as_tensor(b, a.device).float()
    mse = ((a - b) ** 2).mean(dim=tuple(range(1, a.dim())))
    val = 10.0 * torch.log10((max_val * max_val) / mse.clamp_min(1e-12))
    return torch.where(mse == 0, torch.full_like(mse, math.inf), val)


def _ssim_cs(a, b, max_val: float, window: int):
    """Per-batch (ssim, contrast-structure) over non-overlapping
    ``window``×``window`` patches of (N, H, W, C) float32 inputs."""
    n, h, w, c = a.shape
    hh, ww = (h // window) * window, (w // window) * window

    def patches(x):
        x = x[:, :hh, :ww, :].reshape(n, hh // window, window,
                                      ww // window, window, c)
        return x.permute(0, 1, 3, 5, 2, 4).reshape(n, -1, window * window)

    pa, pb = patches(a), patches(b)
    mu_a, mu_b = pa.mean(-1), pb.mean(-1)
    # population variance, as jnp.var
    var_a, var_b = pa.var(-1, correction=0), pb.var(-1, correction=0)
    cov = (pa * pb).mean(-1) - mu_a * mu_b
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    cs = (2 * cov + c2) / (var_a + var_b + c2)
    lum = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    return (lum * cs).mean(-1), cs.mean(-1)


def _nhwc_f32(a, b, device):
    a = as_tensor(a, device)
    a, b = a.float(), as_tensor(b, a.device).float()
    if a.dim() == 3:
        a, b = a[..., None], b[..., None]
    return a, b


def ssim(a, b, *, max_val: float = 255.0, window: int = 8,
         device=None) -> torch.Tensor:
    """Mean SSIM per batch element for (N, H, W) or (N, H, W, C) images,
    over non-overlapping ``window``×``window`` patches (uniform window)."""
    a, b = _nhwc_f32(a, b, device)
    return _ssim_cs(a, b, max_val, window)[0]


#: Wang et al. 2003 per-scale weights (5-scale MS-SSIM)
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _pool2(x):
    n, h, w, c = x.shape
    x = x[:, : (h // 2) * 2, : (w // 2) * 2, :]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def ms_ssim(a, b, *, max_val: float = 255.0, window: int = 8,
            device=None) -> torch.Tensor:
    """Multi-scale SSIM per batch element, (N, H, W[, C]) → (N,).

    Contrast-structure at scales 1-4, full SSIM at the coarsest, 2×2
    average pooling between scales, weighted geometric mean (Wang,
    Simoncelli & Bovik 2003). Scales that would shrink below one window
    are dropped and the weights renormalised, so small frames still
    score.
    """
    a, b = _nhwc_f32(a, b, device)
    levels, h, w = 1, a.shape[1], a.shape[2]
    while levels < len(_MSSSIM_WEIGHTS) and min(h, w) // 2 >= window:
        levels += 1
        h, w = h // 2, w // 2
    total = sum(_MSSSIM_WEIGHTS[:levels])
    vals = []
    for lvl in range(levels):
        s, cs = _ssim_cs(a, b, max_val, window)
        vals.append(s if lvl == levels - 1 else cs)
        if lvl != levels - 1:
            a, b = _pool2(a), _pool2(b)
    # cs/s can dip ≤ 0 on pathological inputs: clamp before the power
    logs = torch.log(torch.stack(vals, dim=-1).clamp_min(1e-6))
    return torch.exp(sum(wt / total * logs[..., i]
                         for i, wt in enumerate(_MSSSIM_WEIGHTS[:levels])))
