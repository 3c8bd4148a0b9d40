"""Weights from a seed and their loading into the port's modules, shared
by the configurations' modules."""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make(leaves, seed: int, device) -> dict:
    """``leaves``: (name, shape, rule) with rule a function of a standard
    normal tensor of that shape. One draw on ``device`` for all of them,
    from a generator seeded with ``seed``; float32."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, shape, rule), part in zip(leaves, flat.split(sizes)):
        out[name] = rule(part.view(shape))
    return out


def normal(std: float):
    return lambda z: z * std


def around(center: float, spread: float):
    return lambda z: center + spread * z


def log_normal(spread: float):
    return lambda z: torch.exp(spread * z)


def load(model: torch.nn.Module, weights: dict) -> torch.nn.Module:
    """A copy of ``weights`` into a module built on the meta device, on
    the weights' device (the program gets its own tensors). Everything the
    module holds besides BatchNorm's batch counters must be given."""
    device = next(iter(weights.values())).device
    model = model.to_empty(device=device)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"weights do not fit the port's model: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            buf.zero_()
    return model.eval()
