"""Shot-boundary detection over a video file (port of
samples/sample_scenecut.py): host decode feeds windows of luma frames to
the device scorer (SSIM + soft-histogram distance, ops/scenecut.py), and
a robust median + MAD threshold turns the scores into shot spans.

    python -m videoprocessingframework_torch.samples.sample_scenecut \
        [input.mp4] [--frames 96] [--batch 32] [--min-score 0.18] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from ..ops.scenecut import detect_cuts, scene_cut_scores
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    yuv420_luma,
)

log = get_logger("sample_scenecut")


def run(luma: np.ndarray, *, batch: int, min_score: float,
        device: torch.device) -> List[Tuple[int, int]]:
    """[N, H, W] u8 luma → shot spans ``[(start, end), …]`` (end
    exclusive). Windows of ``batch`` frames overlap by one, so every
    adjacent pair is scored once (as ``ops.scenecut.segment_shots``)."""
    n = len(luma)
    scores = [scene_cut_scores(luma[i:i + batch], device=device).cpu()
              for i in range(0, n - 1, batch - 1)]
    s = torch.cat(scores).numpy() if scores else np.zeros(0, np.float32)
    cuts = detect_cuts(s, min_score=min_score)
    bounds = [0] + [c + 1 for c in cuts] + [n]
    return list(zip(bounds[:-1], bounds[1:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--min-score", type=float, default=0.18)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)
    if args.batch < 2:
        ap.error("--batch must be at least 2 (a window scores pairs)")

    frames = list(yuv420_luma(args.input, args.frames)[1])
    if not frames:
        log.error("no frames decoded")
        return 1
    shots = run(np.stack(frames), batch=args.batch,
                min_score=args.min_score, device=device)
    log.info("%s: %d frame(s) → %d shot(s)", args.input, shots[-1][1],
             len(shots))
    for i, (s, e) in enumerate(shots):
        log.info("  shot %d: frames [%d, %d) — %d frames", i, s, e, e - s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
