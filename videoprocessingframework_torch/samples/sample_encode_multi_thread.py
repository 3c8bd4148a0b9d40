"""Thread-per-stream encode (port of samples/sample_encode_multi_thread.py).
Each thread owns one encoder session; the native encode calls run without
the GIL, so N sessions scale across host cores.

    python -m \
        videoprocessingframework_torch.samples.sample_encode_multi_thread \
        [--threads 2] [--frames 30] [--size 320x240] [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from .. import compat as nvc
from ._utils import add_device_arg, device_arg, get_logger, parse_size

log = get_logger("sample_encode_multi_thread")


def worker(wid, width, height, frames, gpu_id, results):
    enc = nvc.PyNvEncoder(
        {"codec": "h264", "preset": "P1", "s": f"{width}x{height}",
         "bitrate": "2M"},
        gpu_id,
    )
    rng = np.random.default_rng(wid)
    packet = np.ndarray(shape=(0,), dtype=np.uint8)
    n = 0
    for _ in range(frames):
        frame = rng.integers(0, 255, (width * height * 3 // 2,),
                             dtype=np.uint8)
        if enc.EncodeSingleFrame(frame, packet):
            n += 1
    while enc.FlushSinglePacket(packet):
        n += 1
    results[wid] = n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--size", default="320x240")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)
    w, h = parse_size(args.size)
    results = {}
    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=worker,
                         args=(i, w, h, args.frames, device, results))
        for i in range(args.threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if len(results) != args.threads:
        log.error("%d of %d encoder threads failed",
                  args.threads - len(results), args.threads)
        return 1
    log.info("%d threads encoded %d packets in %.2fs (%.1f fps aggregate)",
             args.threads, sum(results.values()), dt,
             args.threads * args.frames / dt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
