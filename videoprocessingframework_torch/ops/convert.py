"""Batched color-space / pixel-format conversion (PyTorch).

Counterpart of the JAX package's ``ops/convert.py``, the device-side
equivalent of the reference's 23-impl NPP dispatch
(src/TC/src/TasksColorCvt.cpp:1308-1367) plus the RGB_PLANAR extension
pairs:

* every conversion is a batched function over (N, …) plane tensors, so
  one call serves any number of frames;
* 8-bit math runs in float32 (u8 → f32, 3×3 matrix, round half to even,
  saturate, store u8); each channel is ``(m0·y' + m1·u') + m2·v'`` with
  every product and sum rounded on its own, the order of the CUDA
  kernel's plain version;
* the two RGB_PLANAR pairs (NV12 / YUV420 → planar RGB) go through
  :mod:`.csc_cuda`: a CUDA tensor launches the hand-written kernel, a CPU
  tensor takes its plain version. Every other pair is plain PyTorch.

Layout-only pairs return new tensors, never views of their inputs, so a
converted Surface does not alias its source.

Supported (ColorSpace, ColorRange) combinations and defaults are enforced
exactly as the reference does — see ops/colorspace.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..core.exceptions import UnsupportedConversion
from ..core.packet import ColorspaceConversionContext
from ..core.surface import Surface
from ..utils.device import resolve_device
from ..utils.tracing import trace_range
from . import colorspace as cs
from .colorspace import f32
from . import csc_cuda

F = PixelFormat
_F32 = torch.float32


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _upsample2(c: torch.Tensor) -> torch.Tensor:
    """(..., H/2, W/2) → (..., H, W) 2×2 replicate (NPP nearest)."""
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _downsample2(c: torch.Tensor) -> torch.Tensor:
    """(..., H, W) float → (..., H/2, W/2) 2×2 mean."""
    h, w = c.shape[-2], c.shape[-1]
    c = c.reshape(*c.shape[:-2], h // 2, 2, w // 2, 2)
    return (c.sum(dim=-1).sum(dim=-2)) * 0.25


def _deinterleave_uv(uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NV12 chroma (..., H/2, W) → U, V each (..., H/2, W/2) (views)."""
    return uv[..., 0::2], uv[..., 1::2]


def _interleave_uv(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    s = torch.stack([u, v], dim=-1)
    return s.reshape(*s.shape[:-2], s.shape[-2] * 2)


def _packed3(p: torch.Tensor) -> torch.Tensor:
    """(N, H, 3W) interleaved → (N, H, W, 3)."""
    return p.reshape(*p.shape[:-1], p.shape[-1] // 3, 3)


def _pack3(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) → (N, H, 3W)."""
    return img.reshape(*img.shape[:-2], img.shape[-2] * 3)


def _planar3(p: torch.Tensor) -> torch.Tensor:
    """(N, 3H, W) stacked → (N, H, W, 3)."""
    n, h3, w = p.shape
    return torch.movedim(p.reshape(n, 3, h3 // 3, w), 1, -1)


def _to_planar3(img: torch.Tensor) -> torch.Tensor:
    n, h, w, _ = img.shape
    return torch.movedim(img, -1, 1).reshape(n, 3 * h, w)


def _mat3(m, a, b, c, row: int) -> torch.Tensor:
    """(m[row,0]·a + m[row,1]·b) + m[row,2]·c in float32."""
    return f32(m[row, 0]) * a + f32(m[row, 1]) * b + f32(m[row, 2]) * c


# -- core matrix applications (float32) ---------------------------------------


def _apply_to_rgb(y, cb, cr, space: ColorSpace, rng: ColorRange,
                  fixed=None):
    if fixed is not None:
        return _apply_to_rgb_fixed(y, cb, cr, space, rng, *fixed)
    m, off = cs.rgb_from_ycbcr_f32(space, rng)
    ycc = [p.to(_F32) - f32(o) for p, o in zip((y, cb, cr), off)]
    return torch.stack([_round_u8(_mat3(m, *ycc, d)) for d in range(3)], -1)


#: rounding modes for the NPP fixed-point emulation (half_up is the
#: classic DSP `(acc + 2^(q-1)) >> q`; half_even adds the quotient's own
#: LSB so exact ties round to even; truncate is a plain floor shift)
FIXED_ROUNDINGS = ("half_up", "half_even", "truncate")


def quantize_csc_matrix(space: ColorSpace, rng: ColorRange, q: int):
    """Integer CSC coefficients for the fixed-point emulation: the exact
    ITU matrix scaled by 2**q, rounded to nearest — the |ΔM| ≤ 2^-(q+1)
    per-entry model docs/fidelity.md's analytic NPP bound is built on.
    Returns (mq int32 [3,3], off int32 [3]); offsets are exact integers
    (0/16 luma, 128 chroma) so quantization touches only the matrix."""
    if not 1 <= q <= 20:
        # |acc| ≤ 3·255·max|M|·2^q ≈ 1630·2^q must stay inside int32
        raise ValueError(f"q={q} outside the int32-safe range [1, 20]")
    m, off = cs.rgb_from_ycbcr_matrix(space, rng)
    mq = np.rint(np.asarray(m, np.float64) * (1 << q)).astype(np.int32)
    offi = np.rint(np.asarray(off, np.float64)).astype(np.int32)
    return mq, offi


def _apply_to_rgb_fixed(y, cb, cr, space: ColorSpace, rng: ColorRange,
                        q: int = 10, rounding: str = "half_up"):
    """NPP fixed-point emulation: integer matrix × integer pixel with
    coefficient precision ``q`` (fractional bits) and ``rounding``,
    matching the documented structure of NPP's fixed-function CSC kernels
    (TasksColorCvt.cpp:142-169 dispatches to them). All arithmetic is
    int32 — no float anywhere, so the result is bit-exact across devices
    and equal to the JAX package's."""
    if rounding not in FIXED_ROUNDINGS:
        raise ValueError(
            f"rounding={rounding!r} not in {FIXED_ROUNDINGS}"
        )
    mq, offi = quantize_csc_matrix(space, rng, q)
    ycc = [p.to(torch.int32) - int(o) for p, o in zip((y, cb, cr), offi)]
    half = 1 << (q - 1)
    outs = []
    for d in range(3):
        acc = (ycc[0] * int(mq[d, 0]) + ycc[1] * int(mq[d, 1])
               + ycc[2] * int(mq[d, 2]))
        if rounding == "half_up":
            out = (acc + half) >> q
        elif rounding == "half_even":
            out = (acc + half - 1 + ((acc >> q) & 1)) >> q
        else:  # truncate
            out = acc >> q
        outs.append(torch.clamp(out, 0, 255).to(torch.uint8))
    return torch.stack(outs, -1)


def _apply_from_rgb(rgb_f32, space: ColorSpace, rng: ColorRange):
    """(…, 3) float32 RGB → unrounded float32 YCbCr (chroma still full-res)."""
    m, off = cs.ycbcr_from_rgb_matrix(space, rng)
    m = np.asarray(m, np.float32)
    off = np.asarray(off, np.float32)
    r, g, b = rgb_f32.unbind(-1)
    return torch.stack(
        [_mat3(m, r, g, b, d) + f32(off[d]) for d in range(3)], -1)


# -- batched conversions ------------------------------------------------------


def nv12_to_rgb(y, uv, *, space: ColorSpace, rng: ColorRange,
                swap: bool = False, fixed=None):
    """y (N,H,W), uv (N,H/2,W) → (N,H,W,3) RGB (or BGR when swap).

    ``fixed=(q, rounding)`` switches the CSC to the NPP fixed-point
    emulation (integer math, see :func:`_apply_to_rgb_fixed`)."""
    u, v = _deinterleave_uv(uv)
    rgb = _apply_to_rgb(y, _upsample2(u), _upsample2(v), space, rng, fixed)
    return rgb.flip(-1) if swap else rgb


def yuv420_to_rgb(y, u, v, *, space, rng, swap: bool = False, fixed=None):
    rgb = _apply_to_rgb(y, _upsample2(u), _upsample2(v), space, rng, fixed)
    return rgb.flip(-1) if swap else rgb


def yuv444_to_rgb(y, u, v, *, space, rng, swap: bool = False, fixed=None):
    rgb = _apply_to_rgb(y, u, v, space, rng, fixed)
    return rgb.flip(-1) if swap else rgb


def rgb_to_yuv420(img, *, space, rng, swap: bool = False):
    """(N,H,W,3) → y (N,H,W), u, v (N,H/2,W/2)."""
    if swap:
        img = img.flip(-1)
    ycc = _apply_from_rgb(img.to(_F32), space, rng)
    y = _round_u8(ycc[..., 0])
    u = _round_u8(_downsample2(ycc[..., 1]))
    v = _round_u8(_downsample2(ycc[..., 2]))
    return y, u, v


def rgb_to_yuv444(img, *, space, rng, swap: bool = False):
    if swap:
        img = img.flip(-1)
    ycc = _apply_from_rgb(img.to(_F32), space, rng)
    return (
        _round_u8(ycc[..., 0]),
        _round_u8(ycc[..., 1]),
        _round_u8(ycc[..., 2]),
    )


def rgb_to_gray(img):
    w = np.asarray(cs.GRAY_WEIGHTS, np.float32)
    r, g, b = img.to(_F32).unbind(-1)
    return _round_u8(f32(w[0]) * r + f32(w[1]) * g + f32(w[2]) * b)


def p16_to_u8(plane):
    """MSB-aligned 16-bit → 8-bit (reference p16_nv12: /256, round, sat).
    The uint16 plane goes to float32 first: few torch ops take uint16."""
    return _round_u8(plane.to(_F32) * f32(1.0 / 256.0))


def u8_to_f32_unit(img):
    """uint8 → float32 in [0,1] (nppiScale_8u32f semantics)."""
    return img.to(_F32) * f32(1.0 / 255.0)


# -- conversion registry ------------------------------------------------------

_NEEDS_CTX_TO_RGB = "to_rgb"
_NEEDS_CTX_FROM_RGB = "from_rgb"


def _check_combo(pair_key: str, combos_key: str, combo) -> None:
    table = (
        cs.TO_RGB_COMBOS if combos_key == _NEEDS_CTX_TO_RGB else cs.FROM_RGB_COMBOS
    )
    allowed = table[pair_key]
    if combo not in allowed:
        space, rng = combo
        raise UnsupportedConversion(
            f"{pair_key}: {ColorSpace(space).name} / {ColorRange(rng).name} "
            f"conversion isn't supported. Supported combinations: "
            + ", ".join(
                f"({s.name},{r.name})" for s, r in sorted(allowed)
            )
        )


def _as_tensor(p) -> torch.Tensor:
    """A plane as a tensor: host (numpy) planes are copied to the default
    device (CUDA; it raises without a GPU)."""
    if isinstance(p, torch.Tensor):
        return p
    return torch.from_numpy(np.ascontiguousarray(p)).to(resolve_device(None))


class SurfaceConverter:
    """Per-pair converter over Surfaces (PySurfaceConverter analog).

    One instance is bound to (width, height, src_format, dst_format) like
    the reference (PySurfaceConverter.cpp:28-121); ``run()`` applies the
    conversion to a Surface, ``run_planes()`` to batched plane tensors. It
    runs on the device the planes are on; a host Surface is uploaded to
    the default device (CUDA) first. The full pair list matches
    ConvertSurface's dispatch (TasksColorCvt.cpp:1308-1367).
    """

    #: (src, dst) → implementation descriptor
    PAIRS: Dict[Tuple[PixelFormat, PixelFormat], dict] = {}

    def __init__(
        self,
        width: int,
        height: int,
        src_format: PixelFormat,
        dst_format: PixelFormat,
        fidelity: str = "exact",
        fixed_q: int = 10,
        fixed_rounding: str = "half_up",
    ):
        self.width = width
        self.height = height
        self.src_format = PixelFormat(src_format)
        self.dst_format = PixelFormat(dst_format)
        key = (self.src_format, self.dst_format)
        if key not in self.PAIRS:
            raise UnsupportedConversion(
                f"Unsupported pixel format conversion: {self.src_format} "
                f"to {self.dst_format}"
            )
        self._impl = self.PAIRS[key]
        if fidelity not in ("exact", "npp-fixed"):
            raise ValueError(
                f"fidelity={fidelity!r}: expected 'exact' (float math, "
                "round(exact) — the default) or 'npp-fixed' (integer "
                "matrix × integer pixel emulation of NPP's fixed-point "
                "CSC kernels; see docs/fidelity.md)"
            )
        self._fixed = None
        if fidelity == "npp-fixed":
            if not self._impl.get("fixed_ok"):
                raise UnsupportedConversion(
                    f"fidelity='npp-fixed' applies to the YCbCr→RGB "
                    f"matrix conversions (the NPP fixed-function kernels "
                    f"being emulated), not {self.src_format.name}→"
                    f"{self.dst_format.name}"
                )
            if fixed_rounding not in FIXED_ROUNDINGS:
                raise ValueError(
                    f"fixed_rounding={fixed_rounding!r} not in "
                    f"{FIXED_ROUNDINGS}"
                )
            quantize_csc_matrix(  # validates q's int32-safe range
                ColorSpace.BT_709, ColorRange.MPEG, int(fixed_q)
            )
            self._fixed = (int(fixed_q), fixed_rounding)

    def run_planes(
        self, planes: tuple, cc: Optional[ColorspaceConversionContext] = None
    ) -> tuple:
        """Convert batched plane tensors (each with leading N)."""
        planes = tuple(_as_tensor(p) for p in planes)
        impl = self._impl
        kind = impl.get("ctx")
        if kind is None:
            return impl["fn"](*planes)
        default = (
            cs.DEFAULT_TO_RGB if kind == _NEEDS_CTX_TO_RGB else cs.DEFAULT_FROM_RGB
        )
        combo = cs.resolve_ctx(cc, default)
        _check_combo(impl["combos"], kind, combo)
        if self._fixed is not None:
            return impl["fn"](
                *planes, space=combo[0], rng=combo[1], fixed=self._fixed
            )
        return impl["fn"](*planes, space=combo[0], rng=combo[1])

    def run(
        self, src: Surface, cc: Optional[ColorspaceConversionContext] = None
    ) -> Surface:
        """Convert one Surface (adds/strips the batch dim)."""
        if (src.width, src.height) != (self.width, self.height):
            raise ValueError(
                f"Surface is {src.width}x{src.height}, converter is "
                f"{self.width}x{self.height}"
            )
        if src.format != self.src_format:
            raise ValueError(
                f"Surface format {src.format.name} != converter input "
                f"{self.src_format.name}"
            )
        batched = tuple(_as_tensor(p)[None] for p in src.planes)
        with trace_range(self._impl.get("name", "ConvertSurface")):
            out = self.run_planes(batched, cc)
        if not isinstance(out, tuple):
            out = (out,)
        planes = [p[0] for p in out]
        ow, oh = self._impl.get("out_size", lambda w, h: (w, h))(
            self.width, self.height
        )
        return Surface(self.dst_format, ow, oh, planes)

    # same spelling as the reference
    Execute = run


def _register(src, dst, fn, ctx=None, combos=None, name=None,
              fixed_ok=False):
    SurfaceConverter.PAIRS[(src, dst)] = {
        "fn": fn,
        "ctx": ctx,
        "combos": combos,
        "name": name or f"{src.name}->{dst.name}",
        # supports the fixed=(q, rounding) NPP-emulation kwarg
        "fixed_ok": fixed_ok,
    }


# ---- plane-level adapter functions (Surface layout in/out) ----------------

# packed RGB/BGR plane is (N, H, 3W); planar is (N, 3H, W)


def _nv12_rgb(y, uv, *, space, rng, fixed=None):
    return (_pack3(nv12_to_rgb(y, uv, space=space, rng=rng, fixed=fixed)),)


def _nv12_bgr(y, uv, *, space, rng, fixed=None):
    return (_pack3(nv12_to_rgb(y, uv, space=space, rng=rng, swap=True,
                               fixed=fixed)),)


def _yuv420_rgb(y, u, v, *, space, rng, fixed=None):
    return (_pack3(yuv420_to_rgb(y, u, v, space=space, rng=rng,
                                 fixed=fixed)),)


def _yuv420_bgr(y, u, v, *, space, rng, fixed=None):
    return (_pack3(yuv420_to_rgb(y, u, v, space=space, rng=rng, swap=True,
                                 fixed=fixed)),)


def _ycbcr_bgr(y, u, v, *, space, rng, fixed=None):
    return (_pack3(yuv420_to_rgb(y, u, v, space=space, rng=rng, swap=True,
                                 fixed=fixed)),)


def _yuv444_bgr(y, u, v, *, space, rng, fixed=None):
    return (_pack3(yuv444_to_rgb(y, u, v, space=space, rng=rng, swap=True,
                                 fixed=fixed)),)


def _yuv444_rgb(y, u, v, *, space, rng, fixed=None):
    return (_pack3(yuv444_to_rgb(y, u, v, space=space, rng=rng,
                                 fixed=fixed)),)


def _yuv444_rgb_planar(y, u, v, *, space, rng, fixed=None):
    return (_to_planar3(yuv444_to_rgb(y, u, v, space=space, rng=rng,
                                      fixed=fixed)),)


def _rgb_yuv420(p, *, space, rng):
    return rgb_to_yuv420(_packed3(p), space=space, rng=rng)


def _rgb_yuv444(p, *, space, rng):
    return rgb_to_yuv444(_packed3(p), space=space, rng=rng)


def _rgb_planar_yuv444(p, *, space, rng):
    return rgb_to_yuv444(_planar3(p), space=space, rng=rng)


def _bgr_ycbcr(p, *, space, rng):
    return rgb_to_yuv420(_packed3(p), space=space, rng=rng, swap=True)


def _bgr_yuv444(p, *, space, rng):
    # reference bgr_yuv444 (TasksColorCvt.cpp:617-664)
    return rgb_to_yuv444(_packed3(p), space=space, rng=rng, swap=True)


def _nv12_yuv420(y, uv):
    u, v = _deinterleave_uv(uv)
    return y.clone(), u.contiguous(), v.contiguous()


def _yuv420_nv12(y, u, v):
    return y.clone(), _interleave_uv(u, v)


def _p16_nv12(y, uv):
    return p16_to_u8(y), p16_to_u8(uv)


def _rgb_deinterleave(p):
    return (_to_planar3(_packed3(p)).contiguous(),)


def _rgb_interleave(p):
    return (_pack3(_planar3(p)).contiguous(),)


def _swap3(p):
    return (_pack3(_packed3(p).flip(-1)),)


def _nv12_y(y, uv):
    return (y.clone(),)


def _rgb_y(p):
    return (rgb_to_gray(_packed3(p)),)


def _y_yuv444(y):
    return y.clone(), torch.full_like(y, 128), torch.full_like(y, 128)


def _rgb8_rgb32f(p):
    return (u8_to_f32_unit(p),)


def _rgb32f_deinterleave(p):
    return (_to_planar3(_packed3(p)).contiguous(),)


# ---- the 23-pair table (ConvertSurface ctor, TasksColorCvt.cpp:1308-1367) --

_register(F.NV12, F.YUV420, _nv12_yuv420)
_register(F.YUV420, F.NV12, _yuv420_nv12)
_register(F.P10, F.NV12, _p16_nv12)
_register(F.P12, F.NV12, _p16_nv12)
_register(F.NV12, F.RGB, _nv12_rgb, ctx=_NEEDS_CTX_TO_RGB, combos="nv12",
          fixed_ok=True)
_register(F.NV12, F.BGR, _nv12_bgr, ctx=_NEEDS_CTX_TO_RGB, combos="nv12",
          fixed_ok=True)
_register(F.RGB, F.RGB_PLANAR, _rgb_deinterleave)
_register(F.RGB_PLANAR, F.RGB, _rgb_interleave)
_register(
    F.RGB_PLANAR, F.YUV444, _rgb_planar_yuv444,
    ctx=_NEEDS_CTX_FROM_RGB, combos="rgb_yuv444",
)
_register(F.Y, F.YUV444, _y_yuv444)
_register(F.YUV420, F.RGB, _yuv420_rgb, ctx=_NEEDS_CTX_TO_RGB,
          combos="yuv420", fixed_ok=True)
_register(
    F.RGB, F.YUV420, _rgb_yuv420, ctx=_NEEDS_CTX_FROM_RGB, combos="rgb_yuv420"
)
_register(
    F.RGB, F.YUV444, _rgb_yuv444, ctx=_NEEDS_CTX_FROM_RGB, combos="rgb_yuv444"
)
_register(
    F.BGR, F.YCBCR, _bgr_ycbcr, ctx=_NEEDS_CTX_FROM_RGB, combos="bgr_ycbcr"
)
_register(
    F.BGR, F.YUV444, _bgr_yuv444, ctx=_NEEDS_CTX_FROM_RGB, combos="bgr_yuv444"
)
_register(F.RGB, F.BGR, _swap3)
_register(F.BGR, F.RGB, _swap3)
_register(F.YUV420, F.BGR, _yuv420_bgr, ctx=_NEEDS_CTX_TO_RGB,
          combos="yuv420", fixed_ok=True)
_register(F.YCBCR, F.BGR, _ycbcr_bgr, ctx=_NEEDS_CTX_TO_RGB,
          combos="ycbcr", fixed_ok=True)
_register(
    F.YUV444, F.BGR, _yuv444_bgr, ctx=_NEEDS_CTX_TO_RGB,
    combos="yuv444_bgr", fixed_ok=True,
)
_register(
    F.YUV444, F.RGB, _yuv444_rgb, ctx=_NEEDS_CTX_TO_RGB,
    combos="yuv444_rgb", fixed_ok=True,
)
_register(
    F.YUV444, F.RGB_PLANAR, _yuv444_rgb_planar,
    ctx=_NEEDS_CTX_TO_RGB, combos="yuv444_rgb", fixed_ok=True,
)


def _nv12_rgb_planar(y, uv, *, space, rng):
    """Extension pair (not in the reference's 23): NV12 → planar RGB, the
    layout models consume. The hand-written CUDA kernel on a CUDA tensor
    (any even frame size), its plain version on a CPU tensor."""
    n, h, w = y.shape
    out = csc_cuda.nv12_to_rgb_planar(y, uv, space=space, rng=rng)
    return (out.reshape(n, 3 * h, w),)


def _yuv420_rgb_planar(y, u, v, *, space, rng):
    """Extension pair: planar 4:2:0 → planar RGB (the same kernel, planar
    chroma read directly)."""
    n, h, w = y.shape
    out = csc_cuda.yuv420_to_rgb_planar(y, u, v, space=space, rng=rng)
    return (out.reshape(n, 3 * h, w),)


_register(
    F.NV12, F.RGB_PLANAR, _nv12_rgb_planar,
    ctx=_NEEDS_CTX_TO_RGB, combos="nv12",
)
_register(
    F.YUV420, F.RGB_PLANAR, _yuv420_rgb_planar,
    ctx=_NEEDS_CTX_TO_RGB, combos="yuv420",
)
_register(F.NV12, F.Y, _nv12_y)
_register(F.RGB, F.RGB_32F, _rgb8_rgb32f)
_register(F.RGB, F.Y, _rgb_y)
_register(F.RGB_32F, F.RGB_32F_PLANAR, _rgb32f_deinterleave)
