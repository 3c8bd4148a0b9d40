"""Fused per-frame post-processing: resize + CSC + normalize.

:func:`decode_postproc` is the torch path (the JAX package computed it as
one XLA program): uint8 planes → float32 resize matmuls on the Y/Cb/Cr
planes (resize-before-CSC, exact because the colour matrix is affine and
every resize row sums to 1) → colour matrix → output store. Its dense
resize runs through ``torch.matmul``, as XLA ran it outside any Pallas
kernel. :class:`FusedPipeline` binds one configuration and sends inputs
that qualify to the hand-written CUDA kernel (ops/fused_cuda.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..utils.device import check_f32_matmul, resolve_device
from . import colorspace as cs
from .colorspace import f32
from .convert import _deinterleave_uv, _round_u8, _upsample2
from .fused_cuda import (
    fused_cuda_supported,
    fused_nv12_resize_rgb,
    fused_yuv420_resize_rgb,
)
from .normalize import IMAGENET_MEAN, IMAGENET_STD
from .resize import chroma_collapse, resize_matrix

F = PixelFormat
COMPUTE = ("auto", "split_bf16", "highest")
OUTPUTS = ("rgb_u8", "rgb_f32", "normalized", "normalized_nchw")


def _bf16_parts(t: torch.Tensor):
    """hi+lo bf16 split of a float32 constant, as float32 values."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _bf16_split_f32(t: torch.Tensor):
    """Elision-proof hi+lo split of a float32 activation: ``hi`` keeps
    the top 16 bits of each float (exactly bf16-representable) and
    ``lo = t − hi`` is exact in float32 and rounded to bf16."""
    hi = (t.view(torch.int32) & -65536).view(torch.float32)
    return hi, (t - hi).to(torch.bfloat16).float()


def _rows(m, x):  # "oh,nhw->now"
    return torch.matmul(m, x)


def _cols(m, x):  # "pw,nhw->nhp"
    return torch.matmul(x, m.T)


def _split_stage1(xi, m, contract):
    """Integer input × constant matrix as hi+lo bf16 terms (the input is
    exact in bf16, so only the matrix splits). Each product of two bf16
    values is exact in float32, so float32 matmuls of the parts give the
    MXU's bf16-in/f32-accumulate result."""
    hi, lo = _bf16_parts(m)
    xb = xi.to(torch.float32)
    return contract(hi, xb) + contract(lo, xb)


def _split_stage2(t, m, contract):
    """float32 intermediate × constant matrix: hi+lo split of both, the
    lo×lo term dropped (3 terms)."""
    mhi, mlo = _bf16_parts(m)
    thi, tlo = _bf16_split_f32(t)
    return contract(mhi, thi) + contract(mhi, tlo) + contract(mlo, thi)


def _resize_plane2d(x, rmat, cmat, mode):
    """(N, H, W) → (N, out_h, out_w) float32 via the two resize matmuls,
    contracting the cheaper axis first (by MAC count).

    mode "split_bf16" (integer inputs only) keeps the JAX package's
    hi/lo bf16 decomposition, numerically: ≤1 u8 ULP vs the float64
    golden. On this card it is no faster than float32 — it exists for
    parity, not speed.
    """
    oh, ow = rmat.shape[0], cmat.shape[0]
    hin, win = x.shape[-2], x.shape[-1]
    rows_first = oh * hin * win + oh * win * ow <= (
        hin * win * ow + oh * hin * ow
    )
    if mode == "split_bf16" and not x.is_floating_point():
        if rows_first:
            return _split_stage2(_split_stage1(x, rmat, _rows), cmat, _cols)
        return _split_stage2(_split_stage1(x, cmat, _cols), rmat, _rows)
    x = x.to(torch.float32)
    if rows_first:
        return _cols(cmat, _rows(rmat, x))
    return _rows(rmat, _cols(cmat, x))


def unpack_yuv_planes(fmt: PixelFormat, planes):
    """Normalize any decode_postproc input layout to (y, u, v) planes
    plus chroma-subsampling flags.

    Returns ``(y, u, v, subsampled, sub_h)``; ``u``/``v`` are None for
    grayscale sources. ``subsampled`` = 2x2 chroma (4:2:0 family),
    ``sub_h`` = horizontal-only (4:2:2).
    """
    fmt = PixelFormat(fmt)
    if fmt in (F.NV12, F.NV12_PLANAR) and len(planes) == 1:
        # packed: one (N, H·3/2, W) buffer, y rows then uv rows
        packed = planes[0]
        h = packed.shape[-2] * 2 // 3
        planes = (packed[..., :h, :], packed[..., h:, :])
    elif fmt == F.YUV420 and len(planes) == 1:
        # packed planar: y (H rows), then u then v, each H/2×W/2 stored
        # as H/4 rows of width W
        packed = planes[0]
        h = packed.shape[-2] * 2 // 3
        w = packed.shape[-1]
        if h % 4:
            raise ValueError(
                f"packed planar YUV420 requires height % 4 == 0, got "
                f"{h}; pass separate (y, u, v) planes instead"
            )
        lead = packed.shape[:-2]
        chroma = packed[..., h:, :]
        planes = (
            packed[..., :h, :],
            chroma[..., : h // 4, :].reshape(*lead, h // 2, w // 2),
            chroma[..., h // 4:, :].reshape(*lead, h // 2, w // 2),
        )
    subsampled = fmt in (F.NV12, F.NV12_PLANAR, F.YUV420, F.YCBCR, F.P10,
                         F.P12)
    sub_h = fmt == F.YUV422
    if fmt in (F.NV12, F.NV12_PLANAR):
        y, uv = planes
        u, v = _deinterleave_uv(uv)
    elif fmt in (F.YUV420, F.YCBCR, F.YUV422, F.YUV444):
        y, u, v = planes
    elif fmt == F.Y:
        # grayscale: neutral chroma is synthesized at OUTPUT resolution
        (y,) = planes
        u = v = None
    elif fmt in (F.P10, F.P12):
        y, uv = planes
        y = y.to(torch.float32) * (1.0 / 256.0)
        u, v = _deinterleave_uv(uv.to(torch.float32) * (1.0 / 256.0))
    else:
        raise ValueError(f"decode_postproc: unsupported source {fmt}")
    return y, u, v, subsampled, sub_h


def _csc_to_rgb_f32(y, u, v, space, rng):
    m, off = cs.rgb_from_ycbcr_matrix(space, rng)
    dev = y.device
    ycc = torch.stack(
        [y.to(torch.float32), u.to(torch.float32), v.to(torch.float32)],
        dim=-1,
    ) - torch.tensor(off, dtype=torch.float32, device=dev)
    return torch.matmul(ycc, torch.tensor(m, dtype=torch.float32,
                                          device=dev).T)


def _as_tensor(p, device):
    if isinstance(p, torch.Tensor):
        return p.to(device)
    return torch.as_tensor(p, device=device)


def decode_postproc(
    *planes,
    src_format: PixelFormat,
    space: ColorSpace,
    rng: ColorRange,
    out_h: int,
    out_w: int,
    method: str = "lanczos",
    output: str = "rgb_u8",
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    swap: bool = False,
    compute: str = "auto",
    src_window=None,
):
    """Fused (N-batched) decode post-processing — the torch path.

    planes: NV12 → (y, uv) or one packed (N, H·3/2, W); YUV420 →
    (y, u, v) or one packed buffer; YUV422/YUV444 → (y, u, v); Y →
    (y,); P10/P12 → (y, uv) 16-bit MSB-aligned.
    output: 'rgb_u8' (N,H,W,3 u8) | 'rgb_f32' ([0,1]) |
            'normalized' (NHWC f32) | 'normalized_nchw' (NCHW f32).
    compute: 'auto' and 'highest' are full float32 (TF32 off);
            'split_bf16' keeps the JAX package's hi/lo bf16 numerics.
    src_window: optional (y0, x0, h, w) source ROI in luma pixels: only
            that window maps to the output (taps just outside it use the
            real neighbouring pixels).
    """
    if compute not in COMPUTE:
        raise ValueError(f"unknown compute mode {compute!r}")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output mode {output!r}")
    mode = "split_bf16" if compute == "split_bf16" else "highest"
    fmt = PixelFormat(src_format)
    y, u, v, subsampled, sub_h = unpack_yuv_planes(fmt, planes)
    check_f32_matmul(y, "decode_postproc")
    dev = y.device

    gray = u is None
    h_in, w_in = y.shape[-2], y.shape[-1]
    if src_window is not None:
        wy0, wx0, wh, ww = (float(t) for t in src_window)
        rwin, cwin = (wy0, wh), (wx0, ww)
    else:
        rwin = cwin = None
    if (h_in, w_in) != (out_h, out_w) or src_window is not None:
        rm = resize_matrix(h_in, out_h, method, window=rwin)
        cm = resize_matrix(w_in, out_w, method, window=cwin)
        rmat, cmat = torch.from_numpy(rm).to(dev), torch.from_numpy(cm).to(dev)
        y = _resize_plane2d(y, rmat, cmat, mode)
        if gray:
            pass  # neutral chroma synthesized below at output size
        elif subsampled:
            rc = torch.from_numpy(chroma_collapse(rm)).to(dev)
            cc = torch.from_numpy(chroma_collapse(cm)).to(dev)
            u = _resize_plane2d(u, rc, cc, mode)
            v = _resize_plane2d(v, rc, cc, mode)
        elif sub_h:  # 4:2:2 — collapse columns only
            cc = torch.from_numpy(chroma_collapse(cm)).to(dev)
            u = _resize_plane2d(u, rmat, cc, mode)
            v = _resize_plane2d(v, rmat, cc, mode)
        else:
            u = _resize_plane2d(u, rmat, cmat, mode)
            v = _resize_plane2d(v, rmat, cmat, mode)
    elif subsampled:
        u, v = _upsample2(u), _upsample2(v)
    elif sub_h:
        u = u.repeat_interleave(2, dim=-1)
        v = v.repeat_interleave(2, dim=-1)

    if gray:
        u = v = torch.full(y.shape, 128.0, dtype=torch.float32, device=dev)

    rgb = _csc_to_rgb_f32(y, u, v, space, rng)
    if swap:
        rgb = rgb.flip(-1)

    if output == "rgb_u8":
        return _round_u8(rgb)
    x = torch.clamp(rgb * f32(1.0 / 255.0), 0.0, 1.0)
    if output == "rgb_f32":
        return x
    x = (x - torch.tensor(mean, dtype=torch.float32, device=dev)) * (
        1.0 / torch.tensor(std, dtype=torch.float32, device=dev)
    )
    if output == "normalized_nchw":
        return torch.movedim(x, -1, 1)
    return x


class FusedPipeline(nn.Module):
    """Configured fused pipeline: call with batched planes, get model input.

    Binds (src_format, colorimetry, target size, output mode) once.

    ``kernel`` selects the implementation:

    * ``"torch"`` — :func:`decode_postproc`, the torch path.
    * ``"cuda"`` — the hand-written CUDA kernel (ops/fused_cuda.py) for
      YUV420/NV12 u8 batched planes on a CUDA device; anything else
      raises (a CPU tensor included).
    * ``"auto"`` (default) — the CUDA kernel when the input qualifies
      (u8 batched planes on a CUDA device, no ``src_window``, a shape the
      gate accepts), else the torch path.

    Inputs are moved to ``device`` (default CUDA; raises when no GPU is
    present unless ``device="cpu"``). Outputs are NHWC for ``rgb_u8``,
    ``rgb_f32`` and ``normalized``, NCHW for ``normalized_nchw``.
    """

    def __init__(
        self,
        src_format: PixelFormat,
        color_space: ColorSpace,
        color_range: ColorRange,
        out_size: Tuple[int, int],  # (width, height)
        method: str = "lanczos",
        output: str = "rgb_u8",
        mean: Sequence[float] = tuple(IMAGENET_MEAN),
        std: Sequence[float] = tuple(IMAGENET_STD),
        device=None,
        kernel: str = "auto",
        compute: str = "auto",
        src_window=None,
    ):
        super().__init__()
        self.src_format = PixelFormat(src_format)
        self.space = ColorSpace(color_space)
        self.range = ColorRange(color_range)
        self.out_w, self.out_h = out_size
        self.method = method
        if output not in OUTPUTS:
            raise ValueError(f"unknown output mode {output!r}")
        self.output = output
        self.mean = tuple(mean)
        self.std = tuple(std)
        if kernel not in ("auto", "torch", "cuda"):
            raise ValueError(f"kernel must be auto|torch|cuda, got {kernel!r}")
        if compute not in COMPUTE:
            raise ValueError(f"unknown compute mode {compute!r}")
        self.device = resolve_device(device)
        self.src_window = tuple(src_window) if src_window else None
        if kernel == "cuda":
            if self.device.type != "cuda":
                raise ValueError("kernel='cuda' needs a CUDA device")
            if self.src_window is not None:
                raise ValueError("src_window is not available with "
                                 "kernel='cuda'")
        self.kernel = kernel
        self.compute = compute

    def _cuda_planes(self, planes):
        """("planar", y, u, v) for YUV420 sources, ("nv12", y, uv) for
        NV12 sources, or None when this input doesn't qualify."""
        if self.src_window is not None:
            return None
        if any(p.dim() != 3 or p.dtype != torch.uint8 or not p.is_cuda
               for p in planes):
            return None
        fmt = self.src_format
        if fmt == F.NV12 and len(planes) == 2:
            found = ("nv12",) + tuple(planes)
        elif fmt == F.YUV420 and len(planes) == 3:
            found = ("planar",) + tuple(planes)
        elif fmt in (F.NV12, F.YUV420) and len(planes) == 1:
            y, u, v, _, _ = unpack_yuv_planes(fmt, planes)
            if fmt == F.NV12:
                found = ("nv12", y, planes[0][..., y.shape[-2]:, :])
            else:
                found = ("planar", y, u, v)
        else:
            return None
        y = found[1]
        if not fused_cuda_supported(y.shape[-2], y.shape[-1], self.out_h,
                                    self.out_w, self.method):
            return None
        return found

    def _run_cuda(self, mode, *planes):
        kern = (fused_yuv420_resize_rgb if mode == "planar"
                else fused_nv12_resize_rgb)
        out = kern(
            *planes, out_h=self.out_h, out_w=self.out_w, space=self.space,
            rng=self.range, method=self.method,
            output=("normalized" if self.output.startswith("normalized")
                    else self.output),
            mean=self.mean, std=self.std,
        )
        if self.output == "normalized_nchw":
            return out  # the kernel's planar layout IS NCHW
        return out.permute(0, 2, 3, 1)  # planar → NHWC like the torch path

    def _run_torch(self, *planes):
        return decode_postproc(
            *planes, src_format=self.src_format, space=self.space,
            rng=self.range, out_h=self.out_h, out_w=self.out_w,
            method=self.method, output=self.output, mean=self.mean,
            std=self.std, compute=self.compute, src_window=self.src_window,
        )

    def forward(self, *planes):
        planes = tuple(_as_tensor(p, self.device) for p in planes)
        if self.kernel != "torch":
            found = self._cuda_planes(planes)
            if found is not None:
                return self._run_cuda(*found)
            if self.kernel == "cuda":
                raise ValueError(
                    "the CUDA kernel does not take this input (needs "
                    "NV12/YUV420 u8 batched planes on a CUDA device, an "
                    "even frame size and no src_window)"
                )
        return self._run_torch(*planes)
