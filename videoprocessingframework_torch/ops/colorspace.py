"""Color-space math spec: YCbCr ↔ RGB matrices and the supported-combination
tables.

This module is the *semantics contract* for every converter in the
framework. It mirrors what the reference delegates to NPP's fixed-function
kernels (src/TC/src/TasksColorCvt.cpp): which (ColorSpace, ColorRange)
combinations each conversion supports, which are defaults, and the exact
matrix coefficients. Coefficients are the ITU-derived values (BT.601-7 /
BT.709-6); narrow (MPEG) range uses the 219/224 excursions with +16/+128
offsets, full (JPEG) range uses 255 excursions.

Everything here is float64 numpy — the golden definition. The device
paths (ops/fused.py, csrc/fused_resize_csc.cu) compute the same math in
float32 and must match to ≤1 ULP per 8-bit channel.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

import numpy as np

from ..core.enums import ColorRange, ColorSpace

# Luma coefficients (Kr, Kb) per matrix standard.
_KR_KB = {
    ColorSpace.BT_601: (0.299, 0.114),
    ColorSpace.BT_709: (0.2126, 0.0722),
}


def rgb_from_ycbcr_matrix(
    space: ColorSpace, rng: ColorRange
) -> Tuple[np.ndarray, np.ndarray]:
    """(M, off) such that  rgb = M @ (ycbcr - off),  all float64.

    ``ycbcr`` and ``rgb`` are 0..255-scaled column vectors.
    """
    kr, kb = _KR_KB[ColorSpace(space)]
    kg = 1.0 - kr - kb
    # full-range matrix: y in [0,255], cb/cr centered at 128, excursion 255
    m = np.array(
        [
            [1.0, 0.0, 2.0 * (1.0 - kr)],
            [1.0, -2.0 * (1.0 - kb) * kb / kg, -2.0 * (1.0 - kr) * kr / kg],
            [1.0, 2.0 * (1.0 - kb), 0.0],
        ],
        dtype=np.float64,
    )
    if ColorRange(rng) == ColorRange.JPEG:
        off = np.array([0.0, 128.0, 128.0])
        return m, off
    # narrow: y excursion 219 (offset 16), chroma excursion 224
    scale = np.diag([255.0 / 219.0, 255.0 / 224.0, 255.0 / 224.0])
    off = np.array([16.0, 128.0, 128.0])
    return m @ scale, off


def f32(x) -> float:
    """A float32 constant as a Python float (exact), so tensor arithmetic
    with it stays in float32 on any device."""
    return float(np.float32(x))


def rgb_from_ycbcr_f32(
    space: ColorSpace, rng: ColorRange, swap: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """The float32 constants of every device path: the rows of
    :func:`rgb_from_ycbcr_matrix` in OUTPUT channel order (B, G, R when
    ``swap``) and the Y/Cb/Cr offsets."""
    m, off = rgb_from_ycbcr_matrix(ColorSpace(space), ColorRange(rng))
    m = np.asarray(m, np.float32)[[2, 1, 0] if swap else [0, 1, 2]]
    return m, np.asarray(off, np.float32)


def ycbcr_from_rgb_matrix(
    space: ColorSpace, rng: ColorRange
) -> Tuple[np.ndarray, np.ndarray]:
    """(M, off) such that  ycbcr = M @ rgb + off."""
    kr, kb = _KR_KB[ColorSpace(space)]
    kg = 1.0 - kr - kb
    m = np.array(
        [
            [kr, kg, kb],
            [-kr / (2 * (1 - kb)), -kg / (2 * (1 - kb)), 0.5],
            [0.5, -kg / (2 * (1 - kr)), -kb / (2 * (1 - kr))],
        ],
        dtype=np.float64,
    )
    if ColorRange(rng) == ColorRange.JPEG:
        off = np.array([0.0, 128.0, 128.0])
        return m, off
    scale = np.diag([219.0 / 255.0, 224.0 / 255.0, 224.0 / 255.0])
    off = np.array([16.0, 128.0, 128.0])
    return scale @ m, off


#: Gray conversion (NPP RGBToGray semantics): BT.601 luma, full range.
GRAY_WEIGHTS = np.array([0.299, 0.587, 0.114], dtype=np.float64)


# --------------------------------------------------------------------------
# Supported (space, range) combinations per conversion family — the exact
# dispatch the reference implements per NPP impl (TasksColorCvt.cpp):
#   nv12→rgb/bgr      709×{JPEG,MPEG}, 601×JPEG; 601×MPEG unsupported
#   yuv420→rgb/bgr    601×{JPEG,MPEG}; 709 unsupported
#   ycbcr→bgr         601×{JPEG,MPEG}
#   yuv444→bgr        601×{JPEG,MPEG}
#   yuv444→rgb[_pl]   601×JPEG only
#   rgb→yuv420/444    601×{JPEG,MPEG}, default JPEG
#   bgr→ycbcr         601×MPEG (fixed)
# Defaults with no conversion context: (BT_601, MPEG), except rgb→yuv*
# which defaults to (BT_601, JPEG) (TasksColorCvt.cpp:136-137,734).
# --------------------------------------------------------------------------

Combo = Tuple[ColorSpace, ColorRange]


def _combos(*pairs) -> FrozenSet[Combo]:
    return frozenset((ColorSpace(s), ColorRange(r)) for s, r in pairs)


TO_RGB_COMBOS: Dict[str, FrozenSet[Combo]] = {
    "nv12": _combos(
        (ColorSpace.BT_709, ColorRange.JPEG),
        (ColorSpace.BT_709, ColorRange.MPEG),
        (ColorSpace.BT_601, ColorRange.JPEG),
    ),
    "yuv420": _combos(
        (ColorSpace.BT_601, ColorRange.JPEG),
        (ColorSpace.BT_601, ColorRange.MPEG),
    ),
    "ycbcr": _combos(
        (ColorSpace.BT_601, ColorRange.JPEG),
        (ColorSpace.BT_601, ColorRange.MPEG),
    ),
    "yuv444_bgr": _combos(
        (ColorSpace.BT_601, ColorRange.JPEG),
        (ColorSpace.BT_601, ColorRange.MPEG),
    ),
    "yuv444_rgb": _combos((ColorSpace.BT_601, ColorRange.JPEG)),
}

FROM_RGB_COMBOS: Dict[str, FrozenSet[Combo]] = {
    "rgb_yuv420": _combos(
        (ColorSpace.BT_601, ColorRange.JPEG),
        (ColorSpace.BT_601, ColorRange.MPEG),
    ),
    "rgb_yuv444": _combos(
        (ColorSpace.BT_601, ColorRange.JPEG),
        (ColorSpace.BT_601, ColorRange.MPEG),
    ),
    "bgr_ycbcr": _combos((ColorSpace.BT_601, ColorRange.MPEG)),
    # reference bgr_yuv444 (TasksColorCvt.cpp:617-664): BT_601 only,
    # MPEG → nppiBGRToYCbCr, JPEG → nppiBGRToYUV
    "bgr_yuv444": _combos(
        (ColorSpace.BT_601, ColorRange.JPEG),
        (ColorSpace.BT_601, ColorRange.MPEG),
    ),
}

#: default colorimetry when no conversion context is given
DEFAULT_TO_RGB: Combo = (ColorSpace.BT_601, ColorRange.MPEG)
DEFAULT_FROM_RGB: Combo = (ColorSpace.BT_601, ColorRange.JPEG)


def resolve_ctx(cc, default: Combo) -> Combo:
    """Apply the reference's defaulting rules to a conversion context."""
    if cc is None:
        return default
    space = cc.color_space if cc.color_space != ColorSpace.UNSPEC else default[0]
    rng = cc.color_range if cc.color_range != ColorRange.UDEF else default[1]
    return (ColorSpace(space), ColorRange(rng))
