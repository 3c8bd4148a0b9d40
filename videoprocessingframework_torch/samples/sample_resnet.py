"""Decode → fused NV12 resize + colour conversion + normalisation →
ResNet-50 inference (port of samples/sample_jax_resnet.py).

    python -m videoprocessingframework_torch.samples.sample_resnet \
        [input.mp4] [--batch 8] [--frames 32] [--device cpu]

Decoded NV12 frames go to the device a batch at a time. On a CUDA device
:class:`~..ops.fused.FusedPipeline` launches the NV12 instantiation of
the fused_resize_csc kernel (csrc/fused_resize_csc.cu), whose normalized
224² output is the model's input; on the CPU the same pipeline takes the
torch path. The model is ResNet-50 with weights drawn from a seed.
"""

from __future__ import annotations

import argparse
from typing import Iterable, Tuple

import numpy as np
import torch

from .. import compat as nvc
from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..models import resnet50
from ..ops.fused import FusedPipeline
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    kernel_for,
    nv12_batches,
    seeded,
)

log = get_logger("sample_resnet")

#: the model's input size
SIZE = 224


def preprocess(space: ColorSpace, rng: ColorRange, device: torch.device,
               size: int = SIZE) -> FusedPipeline:
    """NV12 (y, uv) batches → normalized NHWC float32 at size²."""
    return FusedPipeline(PixelFormat.NV12, space, rng, (size, size),
                         output="normalized", device=device,
                         kernel=kernel_for(device))


def run(batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        model: torch.nn.Module, *, space: ColorSpace, rng: ColorRange,
        device: torch.device) -> torch.Tensor:
    """NV12 host batches ``(y, uv)``, (B, H, W) and (B, H/2, W) u8 →
    float32 logits [N, classes] on ``device``. ``model`` is on
    ``device``, in eval mode."""
    pre = preprocess(space, rng, device)
    out = []
    with torch.no_grad():
        for y, uv in batches:
            out.append(model(pre(y, uv)).float())
    return torch.cat(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=32)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    dmx = nvc.PyFFmpegDemuxer(args.input)
    model = seeded(resnet50).to(device).eval()
    logits = run(nv12_batches(args.input, args.batch, args.frames, device),
                 model, space=dmx.ColorSpace(), rng=dmx.ColorRange(),
                 device=device)
    top1 = logits.argmax(-1).tolist()
    log.info("classified %d frames; first top-1 class ids: %s",
             len(top1), top1[:8])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
