"""Synthetic test clips through the native software encoder."""

from __future__ import annotations

import ctypes as C
import pathlib
from typing import Optional

import numpy as np

from . import _lib


def _take_packet(lib, h) -> bytes:
    data = C.POINTER(C.c_uint8)()
    size = C.c_size_t()
    meta = _lib.VpfPacketData()
    lib.vpf_encoder_packet(h, C.byref(data), C.byref(size), C.byref(meta))
    return C.string_at(data, size.value)


def make_clip(path, width: int, height: int, frames: int,
              codec: str = "h264", level: Optional[int] = None
              ) -> pathlib.Path:
    """Encode a moving-gradient NV12 clip (the pattern of the JAX
    package's bench clip) into an elementary stream at ``path``. With
    ``level`` the luma pattern is a quarter of the range wide, from
    ``level`` up, so clips made at different levels are told apart by
    their brightness."""
    lib = _lib.load()
    opts = {"codec": codec, "preset": "P1", "s": f"{width}x{height}",
            "bitrate": "8M", "fps": "30", "gop": "30"}
    keys, vals, n = _lib.make_string_arrays(opts)
    h = lib.vpf_encoder_create(keys, vals, n, 0)
    if not h:
        raise RuntimeError(f"encoder create failed: {_lib.last_error()}")
    ys = np.arange(height, dtype=np.uint16)[:, None]
    xs = np.arange(width, dtype=np.uint16)[None, :]
    stream = bytearray()
    u8p = C.POINTER(C.c_uint8)
    try:
        for i in range(frames + 1):
            if i < frames:
                y = ((ys * 2 + xs + i * 7) % 256).astype(np.uint8)
                if level is not None:
                    y = y // 4 + np.uint8(level)
                uv = np.full((height // 2, width), 110 + (i % 40), np.uint8)
                frame = np.concatenate([y.ravel(), uv.ravel()])
                args = (frame.ctypes.data_as(u8p), frame.nbytes, None, 0, i)
            else:
                args = (None, 0, None, 0, -1)  # flush
            while True:
                r = lib.vpf_encoder_encode(h, *args)
                if r == _lib.OK:
                    stream += _take_packet(lib, h)
                    if i < frames:
                        break
                elif r in (_lib.NEED_MORE, _lib.ERR_EOF):
                    break
                else:
                    raise RuntimeError(f"encode failed: {_lib.last_error()}")
    finally:
        lib.vpf_encoder_destroy(h)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bytes(stream))
    return path
