"""Flow-based video stabilisation (port of samples/sample_stabilize.py):
host decode → batched dense flow on the device (pyramidal Lucas-Kanade
for all frame pairs at once) → robust global trajectory → Gaussian-
smoothed camera path → per-frame warp on the device. Reports the
residual frame-to-frame shake before and after.

    python -m videoprocessingframework_torch.samples.sample_stabilize \
        [input.mp4] [--frames 24] [--sigma 5] [--jitter 0] [--out out.y] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from ..ops.stabilize import global_translations, stabilize_clip
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    yuv420_luma,
)

log = get_logger("sample_stabilize")


def add_jitter(clip: np.ndarray, amplitude: float, seed: int = 0
               ) -> Tuple[np.ndarray, int]:
    """Roll each frame but the first by a seeded whole-pixel offset of at
    most ``ceil(amplitude)`` px; returns (clip, that bound)."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(amplitude)) + 1
    jit = rng.integers(-m + 1, m, (len(clip), 2))
    jit[0] = 0
    return np.stack([np.roll(np.roll(f, jy, axis=0), jx, axis=1)
                     for f, (jx, jy) in zip(clip, jit)]), m - 1


def run(clip: np.ndarray, *, sigma: float, device: torch.device
        ) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """[N, H, W] u8 luma → (stabilised clip, per-frame correction [N, 2],
    mean |frame-to-frame motion| before, and after)."""
    out, corr = stabilize_clip(clip, sigma=sigma, device=device)
    raw = float(global_translations(clip, device=device).abs().mean())
    res = float(global_translations(out, device=device).abs().mean())
    return out, corr, raw, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--sigma", type=float, default=5.0,
                    help="camera-path smoothing, in frames")
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="inject synthetic shake of this amplitude (px) "
                         "before stabilizing — demo mode for smooth "
                         "source footage")
    ap.add_argument("--out", help="write stabilized luma as raw .y file")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    frames = list(yuv420_luma(args.input, args.frames)[1])
    if len(frames) < 3:
        log.error("need at least 3 frames, decoded %d", len(frames))
        return 1
    clip = np.stack(frames)
    h, w = clip.shape[1:]
    if args.jitter > 0:
        clip, m = add_jitter(clip, args.jitter)
        log.info("injected synthetic jitter ±%d px", m)

    out, corr, raw, res = run(clip, sigma=args.sigma, device=device)
    log.info("%d frames %dx%d: mean |frame-to-frame motion| %.2f px → "
             "%.2f px after stabilization (sigma=%.1f, max correction "
             "%.1f px)", len(clip), w, h, raw, res, args.sigma,
             float(np.abs(corr).max()))
    if args.out:
        with open(args.out, "wb") as fh:
            fh.write(out.astype(np.uint8).tobytes())
        log.info("wrote %s (%d raw luma frames)", args.out, len(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
