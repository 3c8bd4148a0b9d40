"""Surface ↔ torch tensor round trip including re-encode (port of
samples/sample_torch.py): the luma plane of each decoded Surface is
dimmed in torch, the planes are packed back into a Surface and encoded.

    python -m videoprocessingframework_torch.samples.sample_torch \
        [input.mp4] [--frames 8] [--device cpu]

The device stage is :func:`run`: Surface planes are the device's tensors
(no copy), and the packed result becomes a Surface again without one.
"""

from __future__ import annotations

import argparse
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import compat as nvc
from ..core.enums import PixelFormat
from ..core.surface import Surface
from ..interop import surface_to_torch, torch_to_surface
from ._utils import add_device_arg, default_input, device_arg, get_logger

log = get_logger("sample_torch")


def dim_luma(surface: Surface) -> Surface:
    """NV12 Surface → a new NV12 Surface on the same device with the
    luma scaled by 0.9 (truncated to u8) and the chroma unchanged."""
    y = surface_to_torch(surface, 0)
    y = (y.float() * 0.9).clamp(0, 255).byte()
    uv = surface_to_torch(surface, 1)
    packed = torch.cat([y.reshape(-1), uv.reshape(-1)])
    return torch_to_surface(packed, PixelFormat.NV12, surface.width,
                            surface.height)


def run(surfaces: Iterable[Surface]) -> Iterator[Surface]:
    for s in surfaces:
        yield dim_luma(s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--frames", type=int, default=8)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    dec = nvc.PyNvDecoder(args.input, device)
    w, h = dec.Width(), dec.Height()
    enc = nvc.PyNvEncoder(
        {"codec": "h264", "preset": "P1", "s": f"{w}x{h}", "bitrate": "3M"},
        device,
    )

    def decoded():
        for _ in range(args.frames):
            surf = dec.DecodeSingleSurface()
            if surf.Empty():
                return
            yield surf.core

    packet = np.ndarray(shape=(0,), dtype=np.uint8)
    n = 0
    for s2 in run(decoded()):
        if enc.EncodeSingleSurface(nvc.Surface(s2), packet, sync=True):
            n += 1
    log.info("round-tripped %d frames through torch and re-encoded", n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
