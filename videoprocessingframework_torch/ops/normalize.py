"""Normalization for model-input preparation (torchvision ImageNet style).

The fused pipeline (ops/fused.py) folds this into its store; this
standalone op serves callers that already hold RGB frames.
"""

from __future__ import annotations

from typing import Sequence

import torch

#: torchvision ImageNet constants, as used by the reference's ResNet sample
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(
    img: torch.Tensor,
    *,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    scale: float = 1.0 / 255.0,
    channels_first: bool = False,
) -> torch.Tensor:
    """(N, H, W, C) uint8/float → normalized float32; optionally NCHW out.

    out = (img·scale − mean) / std, with the reciprocal of std taken in
    float32 first (the same rounding as the fused store).
    """
    x = img.to(torch.float32) * torch.tensor(scale, dtype=torch.float32)
    m = torch.tensor(mean, dtype=torch.float32, device=img.device)
    s = torch.tensor(std, dtype=torch.float32, device=img.device)
    x = (x - m) * (1.0 / s)
    if channels_first:
        x = x.permute(0, 3, 1, 2)
    return x
