"""Encode raw NV12 frames into an H.264/HEVC elementary stream (port of
samples/sample_encode.py).

    python -m videoprocessingframework_torch.samples.sample_encode \
        frames.nv12 out.h264 WIDTH HEIGHT [--codec h264] [--preset P4] \
        [--bitrate 5M] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import compat as nvc
from ._utils import add_device_arg, device_arg, get_logger

log = get_logger("sample_encode")


def encode_file(raw_path, out_path, width, height, gpu_id, codec="h264",
                preset="P4", bitrate="5M"):
    enc = nvc.PyNvEncoder(
        {"codec": codec, "preset": preset, "s": f"{width}x{height}",
         "bitrate": bitrate},
        gpu_id,
    )
    fsize = enc.GetFrameSizeInBytes()
    packet = np.ndarray(shape=(0,), dtype=np.uint8)
    sent = recv = 0
    with open(raw_path, "rb") as f, open(out_path, "wb") as out:
        while True:
            chunk = f.read(fsize)
            if len(chunk) != fsize:
                break
            frame = np.frombuffer(chunk, dtype=np.uint8)
            if enc.EncodeSingleFrame(frame, packet):
                out.write(packet.tobytes())
                recv += 1
            sent += 1
        while enc.FlushSinglePacket(packet):
            out.write(packet.tobytes())
            recv += 1
    return sent, recv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", help="raw NV12 file")
    ap.add_argument("output", help="elementary stream output")
    ap.add_argument("width", type=int)
    ap.add_argument("height", type=int)
    ap.add_argument("--codec", default="h264")
    ap.add_argument("--preset", default="P4")
    ap.add_argument("--bitrate", default="5M")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    sent, recv = encode_file(args.input, args.output, args.width, args.height,
                             device_arg(args), args.codec, args.preset,
                             args.bitrate)
    log.info("sent %d frames, wrote %d packets -> %s", sent, recv, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
