"""Fused YUV420/NV12 u8 → Lanczos/bilinear/nearest resize → CSC → planar
RGB: the CUDA kernel's wrapper, its plain PyTorch version and its gate.

The kernel (csrc/fused_resize_csc.cu) replaces the TPU's Pallas family
in ``videoprocessingframework_tpu/ops/pallas_fused.py``: the whole-frame
planar kernel, the two-pass striped pair used for 4K-class frames, and
the NV12 K1/K2 pair. All of them compute one function, split on the TPU
only to fit VMEM; on Hopper one launch per batch computes it.

The resize matrices of ``ops/resize.py`` have a contiguous support of at
most 6 source pixels per output row/column (4 on the half-grid chroma
matrix, 2 bilinear, 1 nearest), so the kernel reads compact tap tables:
a start index and K float32 weights per output row and column, taken
verbatim from the dense matrix (they rebuild it exactly).

Dispatch: a CPU tensor takes :func:`fused_yuv420_resize_rgb_ref` /
:func:`fused_nv12_resize_rgb_ref` (dense float32 matmuls, same CSC and
store); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from . import colorspace as cs
from .colorspace import f32
from .resize import SUPPORTED, chroma_collapse, resize_matrix

OUTPUTS = ("rgb_u8", "rgb_f32", "normalized")
_MODE = {"rgb_u8": 0, "rgb_f32": 1, "normalized": 2}

#: kernel launches since the last reset — a main-path run shows it went
#: through the kernel by this count; comparison launches are excluded by
#: the caller resetting the count around the run it measures
LAUNCHES: Dict[str, int] = {"fused_resize_csc": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- tap tables --------------------------------------------------------------


def tap_table(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Compact form of a dense (n_out, n_in) resize matrix: per output row
    a start index and the K weights ``mat[o, start:start+K]``.

    The support comes from the matrix's NONZERO columns, not from the
    tap formula: edge clamping folds taps onto the border pixel, so a
    border row's support is narrower than the filter. K is the widest
    support (at most ``n_in``); starts are clipped so every window lies
    inside the source axis.
    """
    n_out, n_in = mat.shape
    nz = mat != 0
    first = nz.argmax(axis=1)
    last = n_in - 1 - nz[:, ::-1].argmax(axis=1)
    k = int((last - first + 1).max())
    start = np.minimum(first, n_in - k)
    idx = start[:, None] + np.arange(k)[None, :]
    weights = np.take_along_axis(mat, idx, axis=1).astype(np.float32)
    return start.astype(np.int32), np.ascontiguousarray(weights)


def dense_from_taps(start: np.ndarray, weights: np.ndarray,
                    n_in: int) -> np.ndarray:
    """Rebuild the dense matrix from a tap table (the inverse of
    :func:`tap_table`; tests hold the pair to exact equality)."""
    n_out, k = weights.shape
    mat = np.zeros((n_out, n_in), np.float32)
    idx = start[:, None].astype(np.int64) + np.arange(k)[None, :]
    np.put_along_axis(mat, idx, weights, axis=1)
    return mat


@lru_cache(maxsize=64)
def tap_tables(h: int, w: int, out_h: int, out_w: int, method: str):
    """Row and column tap tables for luma and for the half-grid chroma
    (the collapsed matrix folds the 2× replicate upsample into the
    weights): ``{"rows_y", "rows_c", "cols_y", "cols_c"}`` → (start,
    weights)."""
    rm = resize_matrix(h, out_h, method)
    cm = resize_matrix(w, out_w, method)
    return {
        "rows_y": tap_table(rm),
        "rows_c": tap_table(chroma_collapse(rm)),
        "cols_y": tap_table(cm),
        "cols_c": tap_table(chroma_collapse(cm)),
    }


def fused_cuda_supported(h: int, w: int, out_h: int, out_w: int,
                         method: str = "lanczos") -> bool:
    """Gate of the CUDA kernel: even luma size (4:2:0 chroma), a known
    method, a positive output size. The TPU's H%64/W%128 tiling rules and
    VMEM budget do not apply on this card."""
    return (
        h >= 2 and w >= 2 and h % 2 == 0 and w % 2 == 0
        and out_h >= 1 and out_w >= 1 and method in SUPPORTED
    )


# ---- colour conversion constants ---------------------------------------------


def _csc_consts(space, rng, swap, mean, std):
    """float32 CSC rows in OUTPUT channel order (swap applied), offsets,
    and the per-output-channel mean / reciprocal std."""
    m, off = cs.rgb_from_ycbcr_f32(space, rng, swap)
    inv_std = np.float32(1.0) / np.asarray(std, np.float32)
    return m, off, np.asarray(mean, np.float32), inv_std


def _store(val: torch.Tensor, output: str, mean_i, inv_std_i) -> torch.Tensor:
    """One RGB channel in the requested output mode."""
    if output == "rgb_u8":
        return torch.clamp(torch.round(val), 0.0, 255.0).to(torch.uint8)
    x = torch.clamp(val * f32(1.0 / 255.0), 0.0, 1.0)
    if output == "normalized":
        x = (x - f32(mean_i)) * f32(inv_std_i)
    return x


# ---- plain PyTorch version -----------------------------------------------------


def _mat(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _plain(y, u, v, out_h, out_w, space, rng, method, swap, output, mean,
           std):
    if y.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the plain version is full float32: turn TF32 matmul off"
        )
    dev = y.device
    h, w = y.shape[-2:]
    rm = resize_matrix(h, out_h, method)
    cm = resize_matrix(w, out_w, method)
    rmy, cmy = _mat(rm, dev), _mat(cm, dev)
    rmc, cmc = _mat(chroma_collapse(rm), dev), _mat(chroma_collapse(cm), dev)
    f = torch.float32
    yr = rmy @ y.to(f) @ cmy.T
    ur = rmc @ u.to(f) @ cmc.T
    vr = rmc @ v.to(f) @ cmc.T
    m, off, mean, inv_std = _csc_consts(space, rng, swap, mean, std)
    yr, ur, vr = yr - f32(off[0]), ur - f32(off[1]), vr - f32(off[2])
    chans = [
        _store(f32(m[i, 0]) * yr + f32(m[i, 1]) * ur + f32(m[i, 2]) * vr,
               output, mean[i], inv_std[i])
        for i in range(3)
    ]
    return torch.stack(chans, dim=1)


def fused_yuv420_resize_rgb_ref(y, u, v, *, out_h, out_w,
                                space=ColorSpace.BT_709,
                                rng=ColorRange.MPEG, method="lanczos",
                                swap=False, output="rgb_u8",
                                mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)):
    """Plain version of the kernel on planar YUV420: dense float32 resize
    matrices, the same CSC and store. (B, 3, out_h, out_w)."""
    _check(y, (u, v), 1, output)
    return _plain(y, u, v, out_h, out_w, space, rng, method, swap, output,
                  mean, std)


def fused_nv12_resize_rgb_ref(y, uv, *, out_h, out_w,
                              space=ColorSpace.BT_709, rng=ColorRange.MPEG,
                              method="lanczos", swap=False, output="rgb_u8",
                              mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)):
    """Plain version of the kernel on NV12 (interleaved UV)."""
    _check(y, (uv,), 2, output)
    return _plain(y, uv[..., 0::2], uv[..., 1::2], out_h, out_w, space, rng,
                  method, swap, output, mean, std)


# ---- the kernel ------------------------------------------------------------------


def _check(y, chroma, step, output):
    if output not in OUTPUTS:
        raise ValueError(f"unsupported output {output!r}")
    if y.dim() != 3:
        raise ValueError(f"expected batched (B, H, W) planes, got {y.shape}")
    b, h, w = y.shape
    want = (b, h // 2, (w // 2) * step)
    for p in (y,) + tuple(chroma):
        if p.dtype != torch.uint8:
            raise ValueError(f"planes must be uint8, got {p.dtype}")
        if p.device != y.device:
            raise ValueError("planes must share one device")
    for p in chroma:
        if tuple(p.shape) != want:
            raise ValueError(f"chroma plane {tuple(p.shape)} != {want}")
    if h % 2 or w % 2:
        raise ValueError(f"4:2:0 needs an even frame size, got {h}x{w}")


@lru_cache(maxsize=64)
def _device_tables(h, w, out_h, out_w, method, device: torch.device):
    """Tap tables uploaded once per (shape, method, device)."""
    tabs = tap_tables(h, w, out_h, out_w, method)
    return {
        k: (torch.from_numpy(s).to(device), torch.from_numpy(wt).to(device),
            wt.shape[1])
        for k, (s, wt) in tabs.items()
    }


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(y, c0, c1, step, cstrides, *, out_h, out_w, space, rng, method,
            swap, output, mean, std):
    """Launch the kernel on the current stream; chroma as two base
    pointers with (batch, row, element) strides in bytes."""
    from ..csrc import build

    if not y.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {y.device}")
    b, h, w = y.shape
    if not fused_cuda_supported(h, w, out_h, out_w, method):
        raise ValueError(
            f"shape {h}x{w}->{out_h}x{out_w} ({method}) not supported by "
            "the CUDA kernel"
        )
    if y.stride(-1) != 1 or cstrides[-1] != step:
        raise ValueError("planes must be contiguous along their rows")
    lib = build.load_kernels()
    tabs = _device_tables(h, w, out_h, out_w, method, y.device)
    m, off, mean32, inv_std = _csc_consts(space, rng, swap, mean, std)
    csc = (ctypes.c_float * 18)(
        *np.concatenate([m.ravel(), off, mean32, inv_std]).tolist()
    )
    dtype = torch.uint8 if output == "rgb_u8" else torch.float32
    out = torch.empty((b, 3, out_h, out_w), dtype=dtype, device=y.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(y.device).cuda_stream
    args = [_ptr(y), c0, c1, step, b, y.stride(0), y.stride(1),
            cstrides[0], cstrides[1]]
    for k in ("rows_y", "rows_c", "cols_y", "cols_c"):
        s, wt, kk = tabs[k]
        args += [_ptr(s), _ptr(wt), kk]
    args += [_ptr(out), out_h, out_w, _MODE[output], csc,
             ctypes.c_void_p(stream)]
    with torch.cuda.device(y.device):
        err = lib.vpf_fused_resize_csc(*args)
    if err != 0:
        raise RuntimeError(
            f"fused_resize_csc launch failed: CUDA error {err} "
            f"({build.error_string(err)})"
        )
    LAUNCHES["fused_resize_csc"] += 1
    return out


def fused_yuv420_resize_rgb(y, u, v, *, out_h: int, out_w: int,
                            space=ColorSpace.BT_709, rng=ColorRange.MPEG,
                            method: str = "lanczos", swap: bool = False,
                            output: str = "rgb_u8",
                            mean: Sequence[float] = (0.0, 0.0, 0.0),
                            std: Sequence[float] = (1.0, 1.0, 1.0)):
    """y (B,H,W) + u,v (B,H/2,W/2) u8 → (B, 3, out_h, out_w) planar RGB.

    output: 'rgb_u8' (u8) | 'rgb_f32' ([0,1] f32) | 'normalized'
    ((x−mean)/std f32, positional per OUTPUT channel, i.e. after swap).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    kw = dict(out_h=out_h, out_w=out_w, space=space, rng=rng, method=method,
              swap=swap, output=output, mean=mean, std=std)
    if y.device.type == "cpu":
        return fused_yuv420_resize_rgb_ref(y, u, v, **kw)
    _check(y, (u, v), 1, output)
    if u.stride() != v.stride():
        raise ValueError("u and v planes must share one layout")
    return _launch(y, _ptr(u), _ptr(v), 1, u.stride(), **kw)


def fused_nv12_resize_rgb(y, uv, *, out_h: int, out_w: int,
                          space=ColorSpace.BT_709, rng=ColorRange.MPEG,
                          method: str = "lanczos", swap: bool = False,
                          output: str = "rgb_u8",
                          mean: Sequence[float] = (0.0, 0.0, 0.0),
                          std: Sequence[float] = (1.0, 1.0, 1.0)):
    """y (B,H,W) u8 + interleaved uv (B,H/2,W) u8 → (B, 3, out_h, out_w).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    kw = dict(out_h=out_h, out_w=out_w, space=space, rng=rng, method=method,
              swap=swap, output=output, mean=mean, std=std)
    if y.device.type == "cpu":
        return fused_nv12_resize_rgb_ref(y, uv, **kw)
    _check(y, (uv,), 2, output)
    # U and V interleave: element step 2 within a row, V one byte on
    base = uv.data_ptr()
    strides = (uv.stride(0), uv.stride(1), 2 * uv.stride(2))
    return _launch(y, ctypes.c_void_p(base), ctypes.c_void_p(base + 1), 2,
                   strides, **kw)
