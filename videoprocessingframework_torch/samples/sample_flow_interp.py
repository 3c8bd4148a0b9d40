"""Dense optical flow + motion-compensated frame interpolation (port of
samples/sample_flow_interp.py): host decode, dense pyramidal
Lucas-Kanade flow between luma frames on the device (ops/flow.py), each
temporal midpoint synthesised and scored against the real middle frame
and against the zero-motion baseline (frame repeat).

``--mv`` also densifies the decoder's own motion vectors
(``mv_to_dense_flow``) and reports their coverage.

    python -m videoprocessingframework_torch.samples.sample_flow_interp \
        [input.mp4] [--triplets 4] [--levels 3] [--iters 4] [--mv] \
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.flow import (
    interpolate_midpoint,
    lucas_kanade_flow,
    mv_to_dense_flow,
)
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    yuv420_luma,
)

log = get_logger("sample_flow_interp")


def psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def run(prev: np.ndarray, mid: np.ndarray, nxt: np.ndarray, *, levels: int,
        iters: int, device: torch.device) -> dict:
    """One (prev, mid, next) luma triplet → the median flow magnitude
    prev → next (px), and the PSNR of the synthesised midpoint and of
    the repeated ``prev`` against ``mid`` (dB)."""
    kw = dict(levels=levels, iters=iters, device=device)
    flow = lucas_kanade_flow(prev[None], nxt[None], **kw).cpu().numpy()
    synth = interpolate_midpoint(prev[None], nxt[None], **kw)[0]
    return {"flow": float(np.median(np.hypot(flow[..., 0], flow[..., 1]))),
            "synth": psnr(synth.cpu().numpy(), mid),
            "repeat": psnr(prev, mid)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--triplets", type=int, default=4,
                    help="number of (prev, mid, next) frame triplets")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--mv", action="store_true",
                    help="also densify decoder motion vectors")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    reader, luma = yuv420_luma(args.input, None, export_mvs=args.mv)
    w, h = reader.width(), reader.height()
    log.info("input: %s (%dx%d), %d triplet(s), levels=%d iters=%d",
             args.input, w, h, args.triplets, args.levels, args.iters)

    gains, synths = [], []
    frames = [next(luma, None), next(luma, None), next(luma, None)]
    t = 0
    while all(f is not None for f in frames) and t < args.triplets:
        r = run(*frames, levels=args.levels, iters=args.iters, device=device)
        log.info("triplet %d: median |flow| %.2f px — midpoint PSNR "
                 "%.2f dB vs frame-repeat %.2f dB (%+.2f dB)",
                 t, r["flow"], r["synth"], r["repeat"],
                 r["synth"] - r["repeat"])
        synths.append(r["synth"])
        gains.append(r["synth"] - r["repeat"])
        if args.mv:
            mvs = reader.motion_vectors()
            dense = mv_to_dense_flow(mvs, w, h)
            nz = float(np.mean(np.any(dense != 0, axis=-1)))
            log.info("  codec MVs: %d vectors, %.0f%% coverage",
                     0 if mvs is None else len(mvs), 100 * nz)
        frames = [frames[1], frames[2], next(luma, None)]
        t += 1

    if not synths:
        log.error("no frame triplets decoded")
        return 1
    log.info("interpolated %d midpoint(s): mean PSNR %.2f dB, mean gain "
             "over frame-repeat %+.2f dB", len(synths),
             float(np.mean(synths)), float(np.mean(gains)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
