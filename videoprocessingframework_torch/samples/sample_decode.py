"""Decode sample: built-in vs standalone demux modes, seek, and decoder
error recovery (port of samples/sample_decode.py).

    python -m videoprocessingframework_torch.samples.sample_decode \
        [input.mp4] [output.nv12] [--mode builtin|standalone|seek] \
        [--device cpu]

Decoding is host work (libav); ``--device`` is the session's device, on
which ``DecodeSingleSurface`` would place surfaces.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import compat as nvc
from ._utils import add_device_arg, default_input, device_arg, get_logger

log = get_logger("sample_decode")


def decode_builtin(src: str, dst: str, gpu_id, max_frames=None) -> int:
    dec = nvc.PyNvDecoder(src, gpu_id)
    frame = np.ndarray(shape=(0,), dtype=np.uint8)
    n = 0
    with open(dst, "wb") as out:
        while True:
            try:
                if not dec.DecodeSingleFrame(frame):
                    break
            except nvc.HwResetException:
                log.warning("decoder reset — continuing")
                continue
            except nvc.CuvidParserException:
                log.warning("parser error — stopping")
                break
            out.write(frame.tobytes())
            n += 1
            if max_frames and n >= max_frames:
                break
    return n


def decode_standalone(src: str, dst: str, gpu_id) -> int:
    dmx = nvc.PyFFmpegDemuxer(src)
    dec = nvc.PyNvDecoder(dmx.Width(), dmx.Height(), dmx.Format(),
                          dmx.Codec(), gpu_id)
    packet = np.ndarray(shape=(0,), dtype=np.uint8)
    frame = np.ndarray(shape=(0,), dtype=np.uint8)
    n = 0
    with open(dst, "wb") as out:
        while dmx.DemuxSinglePacket(packet):
            if dec.DecodeFrameFromPacket(frame, packet):
                out.write(frame.tobytes())
                n += 1
        while dec.FlushSingleFrame(frame):
            out.write(frame.tobytes())
            n += 1
    return n


def decode_with_seek(src: str, dst: str, seek_frame: int, gpu_id) -> int:
    dec = nvc.PyNvDecoder(src, gpu_id)
    frame = np.ndarray(shape=(0,), dtype=np.uint8)
    sc = nvc.SeekContext(seek_frame=seek_frame)
    n = 0
    with open(dst, "wb") as out:
        if dec.DecodeSingleFrame(frame, sc):
            out.write(frame.tobytes())
            n += 1
            log.info("seek to frame %d decoded %d frames along the way",
                     seek_frame, sc.num_frames_decoded)
        while dec.DecodeSingleFrame(frame):
            out.write(frame.tobytes())
            n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("output", nargs="?", default="out.nv12")
    ap.add_argument("--mode", default="builtin",
                    choices=["builtin", "standalone", "seek"])
    ap.add_argument("--seek-frame", type=int, default=10)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)
    if args.mode == "builtin":
        n = decode_builtin(args.input, args.output, device)
    elif args.mode == "standalone":
        n = decode_standalone(args.input, args.output, device)
    else:
        n = decode_with_seek(args.input, args.output, args.seek_frame, device)
    log.info("decoded %d frames -> %s", n, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
