"""Transcode quality measurement (port of
samples/sample_measure_video_quality.py): an encode → decode round trip
scored on the device with PSNR, SSIM and luma MS-SSIM (ops/metrics.py).

    python -m \
        videoprocessingframework_torch.samples.sample_measure_video_quality \
        [input.mp4] [--bitrate 2M] [--frames 48] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Tuple

import numpy as np
import torch

from .. import compat as nvc
from ..ops.metrics import ms_ssim, psnr, ssim
from ._utils import add_device_arg, default_input, device_arg, get_logger

log = get_logger("sample_measure_video_quality")


def round_trip(src: str, bitrate: str, max_frames: int, gpu_id
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The first ``max_frames`` decoded frames and their H.264 round trip
    at ``bitrate``: two (K, H·3/2, W) packed YUV420 u8 arrays."""
    dec = nvc.PyNvDecoder(src, gpu_id)
    w, h = dec.Width(), dec.Height()
    enc = nvc.PyNvEncoder(
        {"codec": "h264", "preset": "P4", "s": f"{w}x{h}", "bitrate": bitrate},
        gpu_id,
    )
    originals = []
    stream = np.ndarray(shape=(0,), dtype=np.uint8)
    frame = np.ndarray(shape=(0,), dtype=np.uint8)
    while len(originals) < max_frames and dec.DecodeSingleFrame(frame):
        originals.append(frame.copy())
        enc.EncodeSingleFrame(frame, stream, sync=False, append=True)
    enc.Flush(stream)

    with tempfile.NamedTemporaryFile(suffix=".h264") as tmp:
        tmp.write(stream.tobytes())
        tmp.flush()
        dec2 = nvc.PyNvDecoder(tmp.name, gpu_id)
        recon = []
        out = np.ndarray(shape=(0,), dtype=np.uint8)
        while len(recon) < len(originals) and dec2.DecodeSingleFrame(out):
            recon.append(out.copy())

    k = min(len(originals), len(recon))
    return (np.stack(originals[:k]).reshape(k, h * 3 // 2, w),
            np.stack(recon[:k]).reshape(k, h * 3 // 2, w))


def run(a: np.ndarray, b: np.ndarray, *, device: torch.device
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-frame PSNR and SSIM of packed YUV420 frames (N, H·3/2, W), and
    MS-SSIM of their luma planes (multi-scale pooling must not mix the
    chroma rows stacked below the luma)."""
    h = a.shape[1] * 2 // 3
    p = psnr(a, b, device=device)
    s = ssim(a, b, device=device)
    ms = ms_ssim(a[:, :h], b[:, :h], device=device)
    return p.cpu().numpy(), s.cpu().numpy(), ms.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--bitrate", default="2M")
    ap.add_argument("--frames", type=int, default=48)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)
    a, b = round_trip(args.input, args.bitrate, args.frames, device)
    p, s, ms = run(a, b, device=device)
    log.info("%d frames @ %s: PSNR avg %.2f dB (min %.2f), SSIM avg "
             "%.4f, MS-SSIM (luma) avg %.4f",
             len(a), args.bitrate, p.mean(), p.min(), s.mean(), ms.mean())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
