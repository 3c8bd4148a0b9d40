"""Standalone demuxer + packet-fed decoder with packet metadata (port of
samples/sample_demux_decode.py).

    python -m videoprocessingframework_torch.samples.sample_demux_decode \
        [input.mp4] [--device cpu]

Each decoded frame becomes a Surface on ``--device``.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import compat as nvc
from ._utils import add_device_arg, default_input, device_arg, get_logger

log = get_logger("sample_demux_decode")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    dmx = nvc.PyFFmpegDemuxer(args.input)
    dec = nvc.PyNvDecoder(dmx.Width(), dmx.Height(), dmx.Format(),
                          dmx.Codec(), device)
    packet = np.ndarray(shape=(0,), dtype=np.uint8)
    pdata = nvc.PacketData()
    n = 0
    while dmx.DemuxSinglePacket(packet):
        dmx.LastPacketData(pdata)
        surf = dec.DecodeSurfaceFromPacket(pdata, packet)
        if not surf.Empty():
            n += 1
    while True:
        surf = dec.FlushSingleSurface()
        if surf.Empty():
            break
        n += 1
    log.info("decoded %d surfaces of %dx%d", n, dmx.Width(), dmx.Height())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
