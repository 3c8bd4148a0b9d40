"""Device-side transcode (port of samples/sample_device_transcode.py):
decode → fused YUV → RGB on the device → an RGB-space device op (a
darkened band, an overlay stand-in) → fused RGB → YUV420 encoder feed
(``ops.fused.encode_feed``) at the output size → re-encode on the host.

    python -m videoprocessingframework_torch.samples.sample_device_transcode \
        [input.mp4] [out.h264] [--size 640x360] [--frames 0] [--device cpu]

On a CUDA device the YUV420 → RGB step is the planar instantiation of
the fused_resize_csc kernel at 1:1; ``encode_feed`` and
``planes_to_host_packed`` are torch ops on the device, and one copy
brings each batch back packed for the encoder.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Iterable, Iterator

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..ops.fused import FusedPipeline, encode_feed, planes_to_host_packed
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    kernel_for,
    parse_size,
)

log = get_logger("sample_device_transcode")


def to_rgb(width: int, height: int, space: ColorSpace, rng: ColorRange,
           device: torch.device) -> FusedPipeline:
    """Packed or planar YUV420 batches → RGB float32 in [0, 1], 1:1."""
    return FusedPipeline(PixelFormat.YUV420, space, rng, (width, height),
                         output="rgb_f32", device=device,
                         kernel=kernel_for(device))


def run(rgb_batches: Iterable[torch.Tensor], *, out_w: int, out_h: int,
        space: ColorSpace, rng: ColorRange) -> Iterator[np.ndarray]:
    """Device RGB batches (N, H, W, 3) float32 → the darkened band (rows
    H/3 to H/2 halved) → encode_feed at out_h × out_w → packed YUV420
    host frames (N, out_h·3/2, out_w) u8, one array a batch."""
    for rgb in rgb_batches:
        rgb = rgb.clone()
        rgb[:, rgb.shape[1] // 3: rgb.shape[1] // 2] *= 0.5
        planes = encode_feed(rgb.clamp(0.0, 1.0), out_h=out_h, out_w=out_w,
                             space=space, rng=rng)
        yield planes_to_host_packed(*planes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("output", nargs="?", default="out_device.h264")
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--frames", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)
    out_w, out_h = parse_size(args.size)

    from ..io import NativeDecodePool, VideoEncoder

    pool = NativeDecodePool([args.input], batch_size=4,
                            out_format=PixelFormat.YUV420,
                            max_frames_per_stream=args.frames, device=device)
    space = ColorSpace(pool.color_space)
    rng = ColorRange(pool.color_range)
    enc = VideoEncoder(
        {"codec": "h264", "preset": "P1", "fmt": "YUV420",
         "s": f"{out_w}x{out_h}", "bitrate": "4M", "gop": "30"})
    stream = bytearray()
    n = 0
    try:
        rgb = pool.batches(to_rgb(pool.width, pool.height, space, rng,
                                  device))
        for packed in run(rgb, out_w=out_w, out_h=out_h, space=space,
                          rng=rng):
            for frame in packed:
                out = enc.encode(frame)
                if out is not None:
                    stream += out[0].tobytes()
                n += 1
        for pkt, _ in enc.flush():
            stream += pkt.tobytes()
    finally:
        pool.close()
    pathlib.Path(args.output).write_bytes(bytes(stream))
    log.info("device-transcoded %d frames -> %s (%d bytes)", n, args.output,
             len(stream))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
