"""Roundings for the lower-precision control: the reference computed one
precision below the one the configuration states."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its
    largest magnitude mapped to the format's largest), back in float32:
    the operands an fp8 matrix product would take."""
    t = t.float()
    scale = t.abs().amax().clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale
