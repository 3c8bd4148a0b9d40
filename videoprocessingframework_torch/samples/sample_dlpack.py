"""Zero-copy array interop for decoded surfaces (port of
samples/sample_dlpack.py). A Surface's planes already are torch tensors
(``interop.surface_planes``); other frameworks take them through DLPack,
which this sample shows by importing the luma plane back as a torch
tensor and checking that no copy was made.

    python -m videoprocessingframework_torch.samples.sample_dlpack \
        [input.mp4] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from .. import compat as nvc
from ..interop import surface_planes
from ._utils import add_device_arg, default_input, device_arg, get_logger

log = get_logger("sample_dlpack")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    add_device_arg(ap)
    args = ap.parse_args(argv)

    dec = nvc.PyNvDecoder(args.input, device_arg(args))
    surf = dec.DecodeSingleSurface()
    y, uv = surface_planes(surf.core)
    log.info("luma plane as tensor: shape=%s dtype=%s device=%s mean=%.2f",
             tuple(y.shape), y.dtype, y.device, float(y.float().mean()))
    t = torch.from_dlpack(surf.PlanePtr(0))
    if t.data_ptr() != y.data_ptr():
        log.error("the DLPack import copied the plane")
        return 1
    log.info("as torch tensor: shape=%s dtype=%s (DLPack, zero copy)",
             tuple(t.shape), t.dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
