"""Batched inference over several decoded streams (port of
samples/sample_batch_inference.py): MultiStreamPipeline decodes the
streams on host threads and runs the fused pre-processing on each
batch; ResNet-50 (weights drawn from a seed) classifies it.

    python -m videoprocessingframework_torch.samples.sample_batch_inference \
        [input.mp4] [--streams 2] [--batch 8] [--device cpu]

On a CUDA device the packed NV12 batches go through the NV12
instantiation of the fused_resize_csc kernel.
"""

from __future__ import annotations

import argparse
import time
from typing import Iterable

import torch

from .. import compat as nvc
from ..models import resnet50
from ..ops.fused import FusedPipeline
from ..parallel.streams import MultiStreamPipeline
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    kernel_for,
    seeded,
)

log = get_logger("sample_batch_inference")


def run(batches: Iterable[torch.Tensor], model: torch.nn.Module) -> int:
    """Classify pre-processed device batches; returns the frame count."""
    n = 0
    with torch.no_grad():
        for batch in batches:
            model(batch)
            n += int(batch.shape[0])
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    probe = nvc.PyFFmpegDemuxer(args.input)
    model = seeded(resnet50).to(device).eval()
    pre = FusedPipeline(
        probe.Format(), probe.ColorSpace(), probe.ColorRange(),
        out_size=(224, 224), output="normalized", device=device,
        kernel=kernel_for(device),
    )
    pipe = MultiStreamPipeline([args.input] * args.streams,
                               batch_size=args.batch, postproc=pre,
                               device=device)
    t0 = time.perf_counter()
    n = run(pipe.batches(), model)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    log.info("classified %d frames end-to-end in %.2fs (%.1f fps)", n, dt,
             n / dt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
