"""Multi-process network-stream decode (port of
samples/sample_decode_rtsp.py): one process per camera URL, each feeding
demuxed packets into a standalone packet decoder. Works with rtsp:// and
http:// URLs (libavformat handles the transport; ``--tcp`` passes
``{'rtsp_transport': 'tcp'}``).

    python -m videoprocessingframework_torch.samples.sample_decode_rtsp \
        URL [URL ...] [--seconds 10] [--tcp] [--device cpu]
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import time

import numpy as np

from ._utils import add_device_arg, device_arg, get_logger

log = get_logger("sample_decode_rtsp")


def camera_worker(url: str, seconds: float, opts: dict, device: str,
                  q: mp.Queue) -> None:
    from .. import compat as nvc

    dmx = nvc.PyFFmpegDemuxer(url, opts)
    dec = nvc.PyNvDecoder(dmx.Width(), dmx.Height(), dmx.Format(),
                          dmx.Codec(), device)
    packet = np.ndarray(shape=(0,), dtype=np.uint8)
    pdata = nvc.PacketData()
    frames = 0
    t_end = time.time() + seconds
    while time.time() < t_end and dmx.DemuxSinglePacket(packet):
        dmx.LastPacketData(pdata)
        surf = dec.DecodeSurfaceFromPacket(pdata, packet)
        if not surf.Empty():
            frames += 1
    q.put((url, frames))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("urls", nargs="+", help="rtsp:// or file URLs")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--tcp", action="store_true", help="force TCP transport")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = str(device_arg(args))

    opts = {"rtsp_transport": "tcp"} if args.tcp else {}
    # a CUDA context does not survive fork: start clean interpreters
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=camera_worker,
                         args=(u, args.seconds, opts, device, q))
             for u in args.urls]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    while not q.empty():
        url, frames = q.get()
        log.info("%s: %d frames in %.0fs", url, frames, args.seconds)
    return 0 if all(p.exitcode == 0 for p in procs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
