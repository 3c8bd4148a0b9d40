"""The comparison that decides ``correct``: samples of what the window
produced, held against the plain reference recomputed from the frames
and weights the benchmark made."""

from __future__ import annotations

import numpy as np
import torch

from .reference.preprocess import preprocess


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``
    (reservoir sampling). ``offer(make)`` calls ``make`` only for an item
    it keeps, so what is not kept costs nothing."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = make()


def space_range(params: dict) -> tuple:
    """The mix's colorimetry in the reference's names."""
    return (params["color_space"].lower().replace("_", ""),
            params["color_range"].lower())


def reference_input(planes, params: dict, device, dtype=torch.float32):
    """Normalised model input from host (y, u, v) planes."""
    y, u, v = (torch.from_numpy(np.ascontiguousarray(p)).to(device)
               for p in planes)
    space, rng = space_range(params)
    out = params["out_size"]
    return preprocess(y, u, v, out, out, space, rng, dtype=dtype)


def reference_logits(cell, weights: dict, x: torch.Tensor,
                     block: int = 32) -> torch.Tensor:
    """The configuration's plain forward, ``block`` frames at a time."""
    return torch.cat([cell.reference.forward(weights, x[i:i + block],
                                             cell.config)
                      for i in range(0, len(x), block)])


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap between the program's logits and the reference's,
    over the reference logits' spread across the sampled frames (the RMS
    of each logit's distance from its mean over the frames): a row of
    another frame reads several times 1, and rounding a small share."""
    want = want.double()
    spread = (want - want.mean(0)).pow(2).mean().sqrt()
    gap = (got.double() - want).abs().amax()
    return float(gap / spread) if spread > 0 else float("inf")
