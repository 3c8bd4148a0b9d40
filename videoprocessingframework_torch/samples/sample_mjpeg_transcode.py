"""Split MJPEG → MJPEG transcode with the whole pixel path on the device
(port of samples/sample_mjpeg_transcode.py). Host work is entropy coding
only: packets entropy-decode to DCT coefficients, one device call per
batch runs dequant / IDCT → optional YUV resize → fDCT / requant, and
the coefficients pack back into baseline JFIF. Quality is checked as
the PSNR of a decode of the output against a decode of the input.

With no input (or ``synth``) a synthetic MJPEG clip is written first
with the split encoder (MjpegWriter).

    python -m videoprocessingframework_torch.samples.sample_mjpeg_transcode \
        [input|synth] [out.mjpeg] [--quality 90] [--size WxH] \
        [--frames 0] [--batch 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import tempfile

import numpy as np

from ._utils import add_device_arg, device_arg, get_logger, parse_size

log = get_logger("sample_mjpeg_transcode")


def make_clip(path, w, h, n, device, quality=90) -> str:
    from ..io import MjpegWriter

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        (yy * 255 / h)[..., None] * np.array([1.0, 0.6, 0.3])
        + (xx * 255 / w)[..., None] * np.array([0.0, 0.4, 0.7])
    ) / 2
    with MjpegWriter(str(path), w, h, quality=quality, device=device) as wr:
        frames = np.clip(
            base[None] + rng.normal(0, 4, (n, h, w, 3)), 0, 255
        ).astype(np.uint8)
        wr.write_rgb(frames)
    return str(path)


def decode_rgb(path, device, out_size=None) -> np.ndarray:
    """Every frame of an MJPEG stream as RGB u8 (N, H, W, 3)."""
    from ..io import MjpegReader

    rd = MjpegReader(path, output="rgb_u8", out_size=out_size, device=device)
    return np.concatenate([b.cpu().numpy() for b in rd.batches()])


def psnr_vs_source(src, dst, device) -> float:
    a = decode_rgb(src, device)
    b = decode_rgb(dst, device, out_size=a.shape[1:3])
    n = min(len(a), len(b))
    err = a[:n].astype(np.float64) - b[:n].astype(np.float64)
    return 10 * np.log10(255.0**2 / (err**2).mean())


def run(src, dst, *, quality, out_size, frames, batch, device):
    """Transcode ``src`` to ``dst`` → the transcoder's stats."""
    from ..io import MjpegTranscoder

    with MjpegTranscoder(src, dst, quality=quality, out_size=out_size,
                         batch=batch, max_frames=frames,
                         device=device) as t:
        return t.run()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=None,
                    help="MJPEG source ('synth' or omitted: generate one)")
    ap.add_argument("output", nargs="?", default="out_transcoded.mjpeg")
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument("--size", default=None, help="WxH device resize")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)
    out_size = None
    if args.size:
        w, h = parse_size(args.size)
        out_size = (h, w)

    with tempfile.TemporaryDirectory() as tmp:
        src = args.input
        if src in (None, "synth"):
            src = make_clip(pathlib.Path(tmp) / "src.mjpeg", 320, 240, 8,
                            device)
            log.info("generated source clip %s", src)
        st = run(src, args.output, quality=args.quality, out_size=out_size,
                 frames=args.frames, batch=args.batch, device=device)
        log.info(
            "transcoded %d frames -> %s (%.1f KB/frame) at %.1f fps",
            st.frames, args.output, st.out_bytes / max(st.frames, 1) / 1024,
            st.fps,
        )
        log.info("PSNR vs source decode: %.2f dB",
                 psnr_vs_source(src, args.output, device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
