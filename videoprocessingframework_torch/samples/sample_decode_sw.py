"""Pure-CPU decode via PyFfmpegDecoder → raw YUV file (port of
samples/sample_decode_sw.py).

    python -m videoprocessingframework_torch.samples.sample_decode_sw \
        [input.mp4] [output.yuv] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import compat as nvc
from ._utils import add_device_arg, default_input, device_arg, get_logger

log = get_logger("sample_decode_sw")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("output", nargs="?", default="out_sw.yuv")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    dec = nvc.PyFfmpegDecoder(args.input, {}, device_arg(args))
    frame = np.ndarray(shape=(0,), dtype=np.uint8)
    n = 0
    with open(args.output, "wb") as out:
        while dec.DecodeSingleFrame(frame):
            out.write(frame.tobytes())
            n += 1
    log.info("decoded %d frames (%dx%d) -> %s", n, dec.Width(), dec.Height(),
             args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
