"""Full transcode: decode → (optional resize) → re-encode, keeping the
transcode API shape of the reference (port of samples/sample_transcode.py).

    python -m videoprocessingframework_torch.samples.sample_transcode \
        [input.mp4] [out.h264|out.mp4|out.ts] [--scale WxH] [--fast] \
        [--device cpu]

Frames are decoded on the host, resized as NV12 Surfaces on ``--device``
(``PySurfaceResizer``) and encoded on the host; ``--fast`` is the
overlapped native pipeline (``Transcoder``), same geometry only.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import compat as nvc
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    parse_size,
)

log = get_logger("sample_transcode")


def transcode_fast(src, dst, preset="P1", bitrate="3M"):
    """The overlapped native pipeline (io/transcode.py): decode in the
    pool's C++ worker, encode on this thread. Same geometry only (scaling
    goes through the device path, sample_device_transcode)."""
    from ..io import Transcoder

    t = Transcoder(src, {"preset": preset, "bitrate": bitrate})
    n_pkts = 0
    with open(dst, "wb") as f:
        def write(data, meta):
            nonlocal n_pkts
            f.write(data.tobytes())
            n_pkts += 1

        st = t.run(write)
    log.info(
        "fast transcode: %d frames in %.2fs = %.1f fps (stages: %s)",
        st.frames, st.wall_s, st.fps,
        {k: round(v["mean_ms"], 2) for k, v in t.timer.summary().items()},
    )
    return st.frames, n_pkts


def transcode(src, dst, gpu_id, codec="h264", bitrate="3M", scale=None):
    from ..core.enums import CodecId
    from ..io import StreamMuxer

    dec = nvc.PyNvDecoder(src, gpu_id)
    w, h = dec.Width(), dec.Height()
    ow, oh = (w, h) if not scale else scale
    fps = dec.Framerate()
    enc = nvc.PyNvEncoder(
        {"codec": codec, "preset": "P2", "s": f"{ow}x{oh}",
         "bitrate": bitrate, "fps": str(int(fps))}, gpu_id
    )
    resizer = None
    if (ow, oh) != (w, h):
        resizer = nvc.PySurfaceResizer(ow, oh, nvc.PixelFormat.NV12, gpu_id)
    # container output (mp4/ts) when the extension asks for it, else raw ES
    mux = None
    if dst.endswith((".mp4", ".ts")):
        mux = StreamMuxer(
            dst, CodecId.H264 if codec == "h264" else CodecId.HEVC,
            ow, oh, fps=fps,
        )
    packet = np.ndarray(shape=(0,), dtype=np.uint8)
    pdata = nvc.PacketData()
    n_in = n_out = 0
    raw = None if mux else open(dst, "wb")

    def emit():
        if mux:
            enc.LastPacketData(pdata)
            mux.write(packet, pdata)
        else:
            raw.write(packet.tobytes())

    try:
        while True:
            surf = dec.DecodeSingleSurface()
            if surf.Empty():
                break
            n_in += 1
            if resizer:
                surf = resizer.Execute(surf)
            if enc.EncodeSingleSurface(surf, packet):
                emit()
                n_out += 1
        while enc.FlushSinglePacket(packet):
            emit()
            n_out += 1
    finally:
        if mux:
            mux.close()
        if raw:
            raw.close()
    return n_in, n_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("output", nargs="?", default="transcoded.h264")
    ap.add_argument("--codec", default="h264")
    ap.add_argument("--bitrate", default="3M")
    ap.add_argument("--scale", help="WxH", default=None)
    ap.add_argument(
        "--fast", action="store_true",
        help="overlapped native pipeline (same geometry, h264 ES out)",
    )
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)
    scale = parse_size(args.scale) if args.scale else None
    if args.fast:
        if scale or args.codec != "h264":
            ap.error("--fast supports same-geometry h264 output")
        n_in, n_out = transcode_fast(args.input, args.output,
                                     bitrate=args.bitrate)
    else:
        n_in, n_out = transcode(args.input, args.output, device, args.codec,
                                args.bitrate, scale)
    log.info("transcoded %d frames -> %d packets -> %s", n_in, n_out,
             args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
