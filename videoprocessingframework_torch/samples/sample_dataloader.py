"""Training data loader (port of samples/sample_dataloader.py): shuffled
clip sampling over a video corpus, decoded on the host and
post-processed on the device into [B, T, H, W, C] batches.

    python -m videoprocessingframework_torch.samples.sample_dataloader \
        [inputs ...] [--clip-len 8] [--stride 1] [--batch 2] [--size 224] \
        [--epochs 1] [--workers 0] [--sharded] [--mjpeg] [--device cpu]

``--sharded`` places each batch as a ``DTensor`` sharded over the mesh's
``data`` axis (a world of one when no process group is running).
``--mjpeg`` reads an MJPEG corpus through the split codec; with no
inputs it first writes a synthetic MJPEG clip with ``MjpegWriter``. On a
CUDA device the post-processing is the planar instantiation of the
fused_resize_csc kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import tempfile
import time
from typing import Iterator, Tuple

import numpy as np

from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    world_mesh,
)

log = get_logger("sample_dataloader")


def synth_mjpeg(path: pathlib.Path, device, w: int = 640, h: int = 360,
                n: int = 48) -> str:
    """A seeded MJPEG clip (noise luma, flat chroma) in an AVI."""
    from ..io import MjpegWriter

    rng = np.random.default_rng(0)
    with MjpegWriter(str(path), w, h, container="avi", device=device) as wr:
        y = rng.integers(0, 256, (n, h, w), np.uint8)
        u = np.full((n, h // 2, w // 2), 110, np.uint8)
        v = np.full((n, h // 2, w // 2), 140, np.uint8)
        wr.write_planes(y, u, v)
    return str(path)


def run(loader, epochs: int) -> Iterator[Tuple[int, int, tuple, float]]:
    """Iterate ``epochs`` epochs; yields (epoch, frames, last batch shape,
    seconds) after each."""
    for epoch in range(epochs):
        t0 = time.perf_counter()
        frames, shape = 0, None
        for batch in loader.epoch(epoch):
            shape = tuple(batch.shape)
            frames += int(np.prod(shape[:2]))
        yield epoch, frames, shape, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="*", default=None)
    ap.add_argument("--clip-len", type=int, default=8)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--sharded", action="store_true",
                    help="place batches sharded over a data mesh")
    ap.add_argument("--mjpeg", action="store_true",
                    help="MJPEG corpus via the split codec (host entropy "
                    "decode, device pixel path); with no inputs a "
                    "synthetic MJPEG clip is written")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)
    sources = args.inputs or [default_input()]

    with contextlib.ExitStack() as stack:
        sharding = None
        if args.sharded:
            from ..parallel.mesh import batch_sharding

            mesh = stack.enter_context(world_mesh(device, ("data",)))
            sharding = batch_sharding(mesh)
            log.info("sharding batches over %d device(s)", mesh.size())

        if args.mjpeg:
            from ..data import MjpegClipLoader as cls

            if not args.inputs:
                tmp = stack.enter_context(tempfile.TemporaryDirectory())
                sources = [synth_mjpeg(pathlib.Path(tmp) / "synth.avi",
                                       device)]
                log.info("synthesized MJPEG corpus: %s", sources[0])
        else:
            from ..data import VideoClipLoader as cls

        loader = cls(
            sources,
            clip_len=args.clip_len,
            frame_stride=args.stride,
            batch_size=args.batch,
            out_size=(args.size, args.size),
            output="normalized",
            workers=args.workers,
            drop_last=args.sharded,  # sharded batches must stay full
            sharding=sharding,
            seed=0,
            device=device,
        )
        log.info(
            "corpus: %d file(s) %dx%d, %d clips/epoch, %d batches/epoch",
            len(loader.corpus), loader.corpus.width, loader.corpus.height,
            loader.clips_per_epoch, len(loader),
        )
        for epoch, frames, shape, dt in run(loader, args.epochs):
            log.info("epoch %d: %d frames as %s batches in %.2fs "
                     "(%.1f frames/s)", epoch, frames, shape, dt, frames / dt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
