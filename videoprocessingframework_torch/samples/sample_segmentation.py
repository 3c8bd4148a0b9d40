"""Decode → fused NV12 pre-processing → semantic segmentation (port of
samples/sample_segmentation.py): a fully convolutional head over the
package's ResNet backbone (``models.fcn_resnet``), weights drawn from a
seed, one frame a call as the JAX sample has it.

    python -m videoprocessingframework_torch.samples.sample_segmentation \
        [input.mp4] [--frames 8] [--device cpu]

On a CUDA device the pre-processing is the NV12 instantiation of the
fused_resize_csc kernel, as in sample_resnet.
"""

from __future__ import annotations

import argparse
from typing import Iterable, List, Tuple

import numpy as np
import torch

from .. import compat as nvc
from ..core.enums import ColorRange, ColorSpace
from ..models import fcn_resnet
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    nv12_batches,
    seeded,
)
from .sample_resnet import preprocess

log = get_logger("sample_segmentation")


def run(batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        model: torch.nn.Module, *, space: ColorSpace, rng: ColorRange,
        device: torch.device) -> List[torch.Tensor]:
    """NV12 host batches ``(y, uv)`` → per batch the class mask
    (B, 224, 224) int64 on ``device`` (argmax of the FCN's logits)."""
    pre = preprocess(space, rng, device)
    with torch.no_grad():
        return [model(pre(y, uv)).argmax(-1) for y, uv in batches]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--frames", type=int, default=8)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    dmx = nvc.PyFFmpegDemuxer(args.input)
    model = seeded(fcn_resnet).to(device).eval()
    masks = run(nv12_batches(args.input, 1, args.frames, device), model,
                space=dmx.ColorSpace(), rng=dmx.ColorRange(), device=device)
    log.info("segmented %d frames; mask shape %s", len(masks),
             tuple(masks[-1].shape))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
