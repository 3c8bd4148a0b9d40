"""Per-pixel-format plane geometry rules.

The reference encodes these rules in 15 concrete ``Surface`` subclasses
(src/TC/inc/MemoryInterfaces.hpp:388-841); here they are one declarative
table. A *plane* is a 2-D array of samples; ``shape(w, h)`` gives its
(height, width_in_samples, channels) and dtype for a frame of luma size
``w``×``h``.

Sample-layout conventions (identical to the reference):

* ``NV12``:   luma H×W u8 + interleaved chroma (H/2)×W u8 (U,V,U,V…).
* ``YUV420``: three planes Y H×W, U (H/2)×(W/2), V (H/2)×(W/2).
* ``YUV422``: Y H×W, U H×(W/2), V H×(W/2).
* ``P10/P12``: NV12 layout, 16-bit container, MSB-aligned 10/12-bit samples.
* ``RGB``/``BGR``: one interleaved plane H×(W·3) u8 (channel-last).
* ``RGB_PLANAR``: one (3·H)×W u8 plane (C,H,W stacked).
* ``YUV444``: three H×W planes.
* ``RGB_32F``: interleaved float32; ``RGB_32F_PLANAR``: stacked float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .enums import PixelFormat


@dataclass(frozen=True)
class PlaneSpec:
    """Geometry of one plane relative to the luma size.

    width/height are computed as ``(size * num) // den``; channels is the
    number of interleaved samples per pixel column (e.g. 2 for NV12 chroma,
    3 for packed RGB).
    """

    width_num: int
    width_den: int
    height_num: int
    height_den: int
    channels: int
    dtype: np.dtype

    def shape(self, width: int, height: int) -> Tuple[int, int]:
        h = (height * self.height_num) // self.height_den
        w = (width * self.width_num) // self.width_den * self.channels
        return (h, w)


def _p(wn=1, wd=1, hn=1, hd=1, c=1, dt=np.uint8) -> PlaneSpec:
    return PlaneSpec(wn, wd, hn, hd, c, np.dtype(dt))


#: plane list per format; index order matches the reference's plane order.
PLANE_SPECS: dict[PixelFormat, tuple[PlaneSpec, ...]] = {
    PixelFormat.Y: (_p(),),
    PixelFormat.NV12: (_p(), _p(1, 2, 1, 2, 2)),  # luma, interleaved UV
    PixelFormat.NV12_PLANAR: (_p(), _p(1, 2, 1, 2, 2)),
    PixelFormat.YUV420: (_p(), _p(1, 2, 1, 2), _p(1, 2, 1, 2)),
    PixelFormat.YCBCR: (_p(), _p(1, 2, 1, 2), _p(1, 2, 1, 2)),
    PixelFormat.YUV422: (_p(), _p(1, 2), _p(1, 2)),
    PixelFormat.YUV444: (_p(), _p(), _p()),
    PixelFormat.RGB: (_p(c=3),),
    PixelFormat.BGR: (_p(c=3),),
    PixelFormat.RGB_PLANAR: (_p(hn=3),),  # (3H, W) stacked
    PixelFormat.RGB_32F: (_p(c=3, dt=np.float32),),
    PixelFormat.RGB_32F_PLANAR: (_p(hn=3, dt=np.float32),),
    PixelFormat.P10: (_p(dt=np.uint16), _p(1, 2, 1, 2, 2, np.uint16)),
    PixelFormat.P12: (_p(dt=np.uint16), _p(1, 2, 1, 2, 2, np.uint16)),
    PixelFormat.YUV420_10bit: (
        _p(dt=np.uint16),
        _p(1, 2, 1, 2, 1, np.uint16),
        _p(1, 2, 1, 2, 1, np.uint16),
    ),
    PixelFormat.YUV444_10bit: (
        _p(dt=np.uint16),
        _p(dt=np.uint16),
        _p(dt=np.uint16),
    ),
    PixelFormat.GRAY12: (_p(dt=np.uint16),),
}


def num_planes(fmt: PixelFormat) -> int:
    return len(PLANE_SPECS[fmt])


def plane_shapes(fmt: PixelFormat, width: int, height: int):
    """[(h, w_samples), ...] for every plane of ``fmt`` at luma ``w×h``."""
    return [spec.shape(width, height) for spec in PLANE_SPECS[fmt]]


def plane_dtype(fmt: PixelFormat, plane: int = 0) -> np.dtype:
    return PLANE_SPECS[fmt][plane].dtype


def host_frame_size(fmt: PixelFormat, width: int, height: int) -> int:
    """Total bytes of a tightly-packed host frame.

    Matches the reference's ``Surface::HostMemSize`` /
    ``CudaDownloadSurface`` sizing rules (Tasks.cpp:742-766): e.g.
    NV12/YUV420 = 3/2·W·H, YUV444/RGB = 3·W·H, YUV422 = 2·W·H.
    """
    total = 0
    for spec in PLANE_SPECS[fmt]:
        h, w = spec.shape(width, height)
        total += h * w * spec.dtype.itemsize
    return total


def validate_even_dims(fmt: PixelFormat, width: int, height: int) -> None:
    """Formats with subsampled chroma require even luma dimensions."""
    sub_w = {
        PixelFormat.NV12,
        PixelFormat.NV12_PLANAR,
        PixelFormat.YUV420,
        PixelFormat.YCBCR,
        PixelFormat.YUV422,
        PixelFormat.P10,
        PixelFormat.P12,
        PixelFormat.YUV420_10bit,
    }
    sub_h = sub_w - {PixelFormat.YUV422}
    if fmt in sub_w and width % 2:
        raise ValueError(f"{fmt.name} requires even width, got {width}")
    if fmt in sub_h and height % 2:
        raise ValueError(f"{fmt.name} requires even height, got {height}")
