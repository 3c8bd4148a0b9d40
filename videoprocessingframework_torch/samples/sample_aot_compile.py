"""Ahead-of-time exported inference, the counterpart of a serialized
TensorRT engine (port of samples/sample_aot_compile.py):

1. ``torch.export.export`` of the fixed-batch ``serve`` program
   (ResNet-50 → top-1 class and its softmax confidence) for ONE input
   shape, the analog of building an engine for a fixed binding shape;
2. its FLOPs a batch from ``torch.utils.flop_counter.FlopCounterMode``,
   the engine-inspection analog;
3. ``torch.export.save`` to ``--engine`` and ``torch.export.load`` back:
   the frames are served by the reloaded program, and a wrong input
   shape raises, as an engine's binding check does.

The fused pre-processing stays outside the exported program: the native
decode pool feeds planar YUV420 batches to FusedPipeline (on a CUDA
device the planar instantiation of the fused_resize_csc kernel), whose
normalized output the engine takes.

    python -m videoprocessingframework_torch.samples.sample_aot_compile \
        [input.mp4] [--batch 8] [--engine resnet50.pt2] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import time
from typing import Callable, Iterable, Optional, Tuple

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from .. import compat as nvc
from ..core.enums import PixelFormat
from ..models import resnet50
from ..ops.fused import FusedPipeline
from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    kernel_for,
    seeded,
)

log = get_logger("sample_aot_compile")

#: the model's input size
SIZE = 224


class Serve(nn.Module):
    """normalized NHWC frames → (top-1 class, its softmax probability)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, frames: torch.Tensor):
        logits = self.model(frames).float()
        return logits.argmax(-1), torch.softmax(logits, -1).amax(-1)


def build_engine(model: nn.Module, batch: int, engine_path: pathlib.Path,
                 device: torch.device) -> Callable:
    """Export ``Serve(model)`` for (batch, 224, 224, 3) float32 input,
    save it to ``engine_path`` and return the reloaded program."""
    serve = Serve(model).eval()
    example = torch.zeros(batch, SIZE, SIZE, 3, device=device)
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            serve(example)
        program = torch.export.export(serve, (example,))
    log.info("engine compiled: %.2f GFLOP/batch", fc.get_total_flops() / 1e9)
    torch.export.save(program, str(engine_path))
    log.info("engine serialized: %s (%d bytes)", engine_path,
             engine_path.stat().st_size)
    return torch.export.load(str(engine_path)).module()


def run(batches: Iterable[torch.Tensor], engine: Callable, batch: int
        ) -> Tuple[int, Optional[Tuple[int, float]]]:
    """Serve pre-processed device batches through ``engine``; a ragged
    last batch is dropped (the engine takes one shape). Returns (frames
    served, (class, confidence) of the last batch's first frame)."""
    n, top = 0, None
    with torch.no_grad():
        for frames in batches:
            if frames.shape[0] != batch:
                break
            cls, conf = engine(frames)
            top = (int(cls[0]), float(conf[0]))
            n += frames.shape[0]
    return n, top


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=default_input())
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--engine", default="resnet50.pt2")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)

    from ..io import NativeDecodePool

    probe = nvc.PyFFmpegDemuxer(args.input)
    model = seeded(resnet50).to(device).eval()
    engine = build_engine(model, args.batch, pathlib.Path(args.engine),
                          device)
    pre = FusedPipeline(
        PixelFormat.YUV420, probe.ColorSpace(), probe.ColorRange(),
        out_size=(SIZE, SIZE), output="normalized", device=device,
        kernel=kernel_for(device),
    )
    pool = NativeDecodePool([args.input], batch_size=args.batch,
                            out_format=PixelFormat.YUV420, device=device)
    t0 = time.perf_counter()
    try:
        n, top = run(pool.batches(pre), engine, args.batch)
    finally:
        pool.close()
    dt = time.perf_counter() - t0
    if top is None:
        log.error("no full batch of %d frames was decoded", args.batch)
        return 1
    log.info("served %d frames in %.2fs (%.1f fps); last top-1: class %s "
             "conf %.3f", n, dt, n / dt if dt else 0, *top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
