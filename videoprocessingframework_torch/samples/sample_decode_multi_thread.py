"""Parallel multi-stream decode with batched device post-processing (port
of samples/sample_decode_multi_thread.py): one decode thread a stream
feeding one fused, batched pre-processing call on the device (see
parallel/streams.py).

    python -m \
        videoprocessingframework_torch.samples.sample_decode_multi_thread \
        [input.mp4] [--streams 4] [--batch 8] [--width 424] \
        [--height 232] [--device cpu]
"""

from __future__ import annotations

import argparse

from .. import compat as nvc
from ..ops.fused import FusedPipeline
from ..parallel.streams import MultiStreamPipeline
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    kernel_for,
)

log = get_logger("sample_decode_multi_thread")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=424)
    ap.add_argument("--height", type=int, default=232)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    probe = nvc.PyFFmpegDemuxer(args.input)
    pipe = MultiStreamPipeline(
        [args.input] * args.streams,
        batch_size=args.batch,
        postproc=FusedPipeline(
            probe.Format(), probe.ColorSpace(), probe.ColorRange(),
            out_size=(args.width, args.height), output="rgb_u8",
            device=device, kernel=kernel_for(device),
        ),
        device=device,
    )
    stats = pipe.run()
    log.info(
        "%d streams: %d frames in %.2fs = %.1f aggregate fps",
        args.streams, stats.frames_decoded, stats.wall_s, stats.fps,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
