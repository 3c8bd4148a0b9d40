"""Helpers shared by the samples: the logger, the default input, the
``--device`` argument, seeded models and the NV12 frames of a file."""

from __future__ import annotations

import argparse
import contextlib
import logging
import pathlib
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s [%(levelname)s] %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    return logger


def default_input() -> str:
    """The repository's test clip (848×464, 96 frames of H.264)."""
    return str(pathlib.Path(__file__).resolve().parents[2] / "tests"
               / "assets" / "test.mp4")


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device of the device stage (default: cuda, "
                    "which raises without a GPU; 'cpu' runs on the CPU)")


def device_arg(args: argparse.Namespace) -> torch.device:
    return resolve_device(args.device)


def kernel_for(device: torch.device) -> str:
    """FusedPipeline's ``kernel``: the CUDA kernel on a CUDA device (an
    input it does not take raises), the torch path on the CPU."""
    return "cuda" if device.type == "cuda" else "torch"


def seeded(build: Callable[[], torch.nn.Module], seed: int = 0
           ) -> torch.nn.Module:
    """``build()`` with its weights drawn from ``seed``, leaving the
    global generator as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


@contextlib.contextmanager
def world_mesh(device: torch.device, axes: Tuple[str, ...],
               shape: Optional[Tuple[int, ...]] = None):
    """A mesh over the whole ``torch.distributed`` world on
    ``device.type``; without a process group, a world of one that is
    taken down on exit."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    started = not dist.is_initialized()
    mesh = make_mesh(axes=axes, shape=shape, device_type=device.type)
    try:
        yield mesh
    finally:
        if started:
            dist.destroy_process_group()


def parse_size(text: str) -> Tuple[int, int]:
    """'WxH' → (width, height)."""
    w, h = (int(x) for x in text.split("x"))
    return w, h


def nv12_batches(src: str, batch: int, max_frames: int, gpu_id
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``(y, uv)`` NV12 host batches, (B, H, W) and (B, H/2, W), of the
    first ``max_frames`` frames of ``src``, decoded by ``PyNvDecoder``."""
    from .. import compat as nvc

    dec = nvc.PyNvDecoder(src, gpu_id)
    w, h = dec.Width(), dec.Height()
    frame = np.ndarray(shape=(0,), dtype=np.uint8)
    ys, uvs, n = [], [], 0
    while n < max_frames and dec.DecodeSingleFrame(frame):
        packed = frame.reshape(h * 3 // 2, w)
        ys.append(packed[:h].copy())
        uvs.append(packed[h:].copy())
        n += 1
        if len(ys) == batch:
            yield np.stack(ys), np.stack(uvs)
            ys, uvs = [], []
    if ys:
        yield np.stack(ys), np.stack(uvs)


def yuv420_luma(src: str, max_frames: Optional[int], export_mvs=False):
    """(reader, iterator of (H, W) luma frames) over ``src`` decoded as
    planar YUV420, at most ``max_frames`` of them (None: all)."""
    from ..core.enums import PixelFormat
    from ..io.decoder import VideoReader

    reader = VideoReader(src, export_mvs=export_mvs)
    reader.decoder.output_format = PixelFormat.YUV420
    h, w = reader.height(), reader.width()
    buf = np.empty((h * 3 // 2, w), np.uint8)

    def frames():
        n = 0
        while (max_frames is None or n < max_frames) and \
                reader.decode(out=buf) is not None:
            n += 1
            yield buf[:h].copy()

    return reader, frames()
