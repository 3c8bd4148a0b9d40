"""Decode → convert → on-screen display via OpenCV (port of
samples/sample_display.py). Frames are converted to BGR on ``--device``,
downloaded and shown with cv2. Without a DISPLAY it decodes and converts
without showing, and needs no cv2.

    python -m videoprocessingframework_torch.samples.sample_display \
        [input.mp4] [--frames 96] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import compat as nvc
from ._utils import add_device_arg, default_input, device_arg, get_logger

log = get_logger("sample_display")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--frames", type=int, default=96)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    cv2 = None
    if not os.environ.get("DISPLAY"):
        log.warning("no DISPLAY — decoding without showing")
    else:
        try:
            import cv2
        except ImportError:
            log.error("cv2 not available")
            return 1

    dec = nvc.PyNvDecoder(args.input, device)
    w, h = dec.Width(), dec.Height()
    cc = nvc.ColorspaceConversionContext(dec.ColorSpace(), dec.ColorRange())
    to_bgr = nvc.PySurfaceConverter(
        w, h, nvc.PixelFormat.NV12, nvc.PixelFormat.BGR, device
    )
    down = nvc.PySurfaceDownloader(w, h, nvc.PixelFormat.BGR, device)
    frame = np.ndarray(shape=(0,), dtype=np.uint8)
    shown = 0
    for _ in range(args.frames):
        surf = dec.DecodeSingleSurface()
        if surf.Empty():
            break
        bgr = to_bgr.Execute(surf, cc)
        if bgr.Empty() or not down.DownloadSingleSurface(bgr, frame):
            continue
        if cv2 is not None:
            cv2.imshow("vpf-torch", frame.reshape(h, w, 3))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
        shown += 1
    log.info("processed %d frames", shown)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
