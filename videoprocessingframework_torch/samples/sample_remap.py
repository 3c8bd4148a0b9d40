"""Fisheye-style undistort via PySurfaceRemaper with x/y maps (port of
samples/sample_remap.py; a synthetic barrel-distortion map is generated
when no .npz is given).

    python -m videoprocessingframework_torch.samples.sample_remap \
        [input.mp4] [--maps maps.npz] [--frames 4] [--device cpu]

The device stage is :func:`run`: NV12 Surface → RGB (PySurfaceConverter)
→ remap (PySurfaceRemaper).
"""

from __future__ import annotations

import argparse
from typing import Iterable, Iterator

import numpy as np

from .. import compat as nvc
from ._utils import add_device_arg, default_input, device_arg, get_logger

log = get_logger("sample_remap")


def barrel_maps(w: int, h: int, k: float = 0.18):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = w / 2, h / 2
    nx, ny = (xs - cx) / cx, (ys - cy) / cy
    r2 = nx * nx + ny * ny
    scale = 1.0 + k * r2
    return (cx + nx * scale * cx).astype(np.float32), (
        cy + ny * scale * cy
    ).astype(np.float32)


def run(surfaces: Iterable[nvc.Surface], xmap, ymap, cc, device
        ) -> Iterator[nvc.Surface]:
    """NV12 Surfaces (all of one size) → remapped RGB Surfaces."""
    to_rgb = remap = None
    for surf in surfaces:
        if to_rgb is None:
            to_rgb = nvc.PySurfaceConverter(
                surf.Width(), surf.Height(), nvc.PixelFormat.NV12,
                nvc.PixelFormat.RGB, device)
            remap = nvc.PySurfaceRemaper(xmap, ymap, nvc.PixelFormat.RGB,
                                         device)
        yield remap.Execute(to_rgb.Execute(surf, cc))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--maps", help=".npz with arrays 'xmap'/'ymap'")
    ap.add_argument("--frames", type=int, default=4)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    dec = nvc.PyNvDecoder(args.input, device)
    w, h = dec.Width(), dec.Height()
    if args.maps:
        data = np.load(args.maps)
        xmap, ymap = data["xmap"], data["ymap"]
    else:
        xmap, ymap = barrel_maps(w, h)
    cc = nvc.ColorspaceConversionContext(dec.ColorSpace(), dec.ColorRange())

    def decoded():
        for _ in range(args.frames):
            surf = dec.DecodeSingleSurface()
            if surf.Empty():
                return
            yield surf

    n = 0
    for out in run(decoded(), xmap, ymap, cc, device):
        if out.Empty() or out.Width() != xmap.shape[1]:
            log.error("remap gave %s", out)
            return 1
        n += 1
    log.info("remapped %d frames to %dx%d", n, xmap.shape[1], xmap.shape[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
