"""Dynamic-batching inference serving (port of samples/sample_serving.py):
decoded frames submitted from concurrent client threads are batched by
the server into padded static-shape buckets, and each batch runs the
fused pre-processing and the model.

    python -m videoprocessingframework_torch.samples.sample_serving \
        [input.mp4] [--clients 4] [--frames 32] [--max-batch 8] \
        [--wait-ms 5] [--device cpu]

On a CUDA device the packed YUV420 frames go through the planar
instantiation of the fused_resize_csc kernel (64², rgb_f32) into a
ResNet18-like classifier with weights drawn from a seed.
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..models import resnet18_like
from ..ops.fused import FusedPipeline
from ..serving import InferenceServer
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    kernel_for,
    seeded,
)

log = get_logger("sample_serving")

#: the model's input size
SIZE = 64


def run(frames: Sequence[np.ndarray], model: torch.nn.Module, *,
        space: ColorSpace, rng: ColorRange, device: torch.device,
        clients: int, max_batch: int, wait_ms: float
        ) -> Tuple[List[torch.Tensor], dict, float]:
    """Serve packed YUV420 host frames (H·3/2, W) u8 from ``clients``
    threads. Returns (the logits of each frame in order, the server's
    snapshot, the wall seconds)."""
    pre = FusedPipeline(PixelFormat.YUV420, space, rng, (SIZE, SIZE),
                        output="rgb_f32", device=device,
                        kernel=kernel_for(device))

    def serve_fn(packed):
        with torch.no_grad():
            return model(pre(packed))

    out: List[torch.Tensor] = [None] * len(frames)
    with InferenceServer(serve_fn, frames[0].shape, max_batch=max_batch,
                         max_wait_ms=wait_ms, device=device) as srv:
        srv.warmup()
        log.info("server warm (%s buckets)", srv.buckets)
        per = (len(frames) + clients - 1) // clients
        t0 = time.perf_counter()

        def client(cid):
            for i in range(cid * per, min((cid + 1) * per, len(frames))):
                out[i] = srv.infer(frames[i], timeout=120)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        snap = srv.snapshot()
    return out, snap, dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--wait-ms", type=float, default=5.0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    from ..io.decoder import VideoReader

    rd = VideoReader(args.input)
    rd.decoder.output_format = PixelFormat.YUV420
    h, w = rd.height(), rd.width()
    space, rng = rd.color_space(), rd.color_range()
    if space == ColorSpace.UNSPEC:
        space = ColorSpace.BT_601
    if rng == ColorRange.UDEF:
        rng = ColorRange.MPEG
    frames = []
    for f in rd.frames():
        frames.append(f.data.reshape(h * 3 // 2, w).copy())
        if len(frames) >= args.frames:
            break
    log.info("decoded %d frames %dx%d", len(frames), w, h)

    model = seeded(lambda: resnet18_like(num_classes=10)).to(device).eval()
    out, snap, dt = run(frames, model, space=space, rng=rng, device=device,
                        clients=args.clients, max_batch=args.max_batch,
                        wait_ms=args.wait_ms)
    if any(o is None for o in out):
        log.error("a request was not answered")
        return 1
    log.info(
        "served %d requests from %d clients in %.2fs (%.1f qps) — "
        "%d batches (mean %.1f), p50 %.1f ms p99 %.1f ms",
        snap["requests"], args.clients, dt, snap["requests"] / dt,
        snap["batches"], snap["mean_batch"],
        snap.get("latency_ms_p50", -1), snap.get("latency_ms_p99", -1),
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
