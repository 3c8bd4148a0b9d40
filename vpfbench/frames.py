"""Seeded 1080p-class YUV420 frames, made on the device in a few large
calls and brought to host memory, where a decoder would leave them.

Each plane is noise over a coarse pattern of 27 × 32 blocks, so frames
still differ after a resize to model size (noise alone resizes to flat
grey): the idea of the port's ``data/loader.py:seeded_frames``, written
anew here.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCKS = (27, 32)


def _plane(n, h, w, g, device):
    noise = torch.randint(0, 128, (n, h, w), generator=g, device=device,
                          dtype=torch.uint8)
    coarse = torch.randint(0, 128, (n,) + BLOCKS, generator=g,
                           device=device, dtype=torch.uint8)
    rows = torch.arange(h, device=device) * BLOCKS[0] // h
    cols = torch.arange(w, device=device) * BLOCKS[1] // w
    return noise + coarse[:, rows][:, :, cols]


def yuv420(n: int, height: int, width: int, seed: int, device):
    """(y, u, v) uint8 planes of ``n`` frames on ``device``."""
    if height % 2 or width % 2:
        raise ValueError(f"YUV420 needs even sides, got {height}x{width}")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    y = _plane(n, height, width, g, device)
    u = _plane(n, height // 2, width // 2, g, device)
    v = _plane(n, height // 2, width // 2, g, device)
    return y, u, v


def ring_slots(y, u, v, batch: int) -> list:
    """Plane-major host batches ([Y×batch | U×batch | V×batch], flat
    uint8 numpy), ``len(y) // batch`` of them."""
    return [torch.cat([p[k:k + batch].reshape(-1) for p in (y, u, v)])
            .cpu().numpy() for k in range(0, len(y), batch)]


def slot_planes(slot: np.ndarray, batch: int, height: int, width: int):
    """(y, u, v) numpy views of one plane-major slot."""
    ysz, csz = height * width, (height // 2) * (width // 2)
    y = slot[:batch * ysz].reshape(batch, height, width)
    u = slot[batch * ysz:batch * (ysz + csz)]
    v = slot[batch * (ysz + csz):batch * (ysz + 2 * csz)]
    half = (batch, height // 2, width // 2)
    return y, u.reshape(half), v.reshape(half)
