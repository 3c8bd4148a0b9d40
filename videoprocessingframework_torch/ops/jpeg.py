"""JPEG decode and encode as device matmuls: the device half of the split
MJPEG codec — the counterpart of the JAX package's ``ops/jpeg.py``.

For a coefficient block ``c`` (64 int16, zigzag order), dequantization and
the 2-D inverse DCT are together one linear map,

    pixels[block] = c @ B + 128,   B[k, p] = Q[k] · f(p_y, v_k) · f(p_x, u_k)

where ``B`` folds the quant table, the zigzag permutation and the
separable IDCT basis into one 64×64 matrix. A batch of frames decodes as
one [N·blocks, 64] × [64, 64] float32 ``torch.matmul`` per component (the
JAX package ran these einsums in XLA at ``precision="highest"``, outside
any Pallas kernel; TF32 is refused here for the same precision), then a
reshape/transpose reassembles the planes and rounds them to u8. The fused
output modes hand the u8 planes to :class:`~.fused.FusedPipeline` —
4:2:0 CUDA planes of an even size take the hand-written band kernel,
everything else ``decode_postproc`` — or, with ``augment=``, to
:class:`~.augment.AugmentPipeline`.

The encoder runs the inverse: level shift + forward DCT + quantization as
one matmul by :func:`fdct_quant_basis`, rounded half to even and clipped
to ±2047. The transcoder composes the two with the u8 clamp between.

Quant-table bases are built once per table set (and device) and reach
the card by pinned non-blocking copies, so a table change costs no host
wait.

Fidelity: ≤1 u8 code against the float64 golden (:func:`golden_decode`);
coefficients ≤1 against :func:`golden_encode`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..utils.device import check_f32_matmul, resolve_device, to_device
from .convert import _round_u8

__all__ = [
    "ZIGZAG",
    "dequant_idct_basis",
    "fdct_quant_basis",
    "std_quant_tables",
    "encode_geometry",
    "JpegDevicePipeline",
    "JpegDeviceEncoder",
    "JpegDeviceTranscoder",
    "golden_decode",
    "golden_encode",
]

# zigzag scan order: ZIGZAG[k] = row-major frequency index (v*8+u) of the
# k-th coefficient in the bitstream (ITU T.81 Figure A.6)
ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)


def _idct_1d_basis() -> np.ndarray:
    """f[x, u] = c(u)/2 · cos((2x+1)uπ/16) — the 8-point IDCT basis."""
    x = np.arange(8, dtype=np.float64)[:, None]
    u = np.arange(8, dtype=np.float64)[None, :]
    f = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16.0)
    f[:, 0] *= 1.0 / np.sqrt(2.0)
    return f


def _block_basis() -> np.ndarray:
    """b[py*8+px, k] = f[py, v_k] · f[px, u_k] for zigzag index k."""
    f = _idct_1d_basis()
    v, u = ZIGZAG // 8, ZIGZAG % 8
    return (f[:, v][:, None, :] * f[:, u][None, :, :]).reshape(64, 64)


def dequant_idct_basis(qt, dtype=np.float64) -> np.ndarray:
    """(64, 64) matrix mapping a zigzag coefficient block to its 64
    row-major pixels, with the quant table (zigzag order) folded in:
    ``pixels = coeffs @ B + 128``."""
    qt = np.asarray(qt, np.float64).reshape(64)
    return np.ascontiguousarray((_block_basis().T * qt[:, None]).astype(dtype))


def fdct_quant_basis(qt, dtype=np.float64) -> np.ndarray:
    """(64, 64) forward matrix: ``coeffs_zigzag = rint((pix - 128) @ A)``
    for a row-major 64-pixel block, with quantization by ``qt`` (zigzag
    order) folded in. At qt == 1 it is the transpose, and the inverse, of
    :func:`dequant_idct_basis`."""
    qt = np.asarray(qt, np.float64).reshape(64)
    return np.ascontiguousarray((_block_basis() / qt[None, :]).astype(dtype))


# ITU T.81 Annex K "typical" quantization tables (K.1/K.2), natural
# row-major order.
_STD_QT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
_STD_QT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int64)


def std_quant_tables(quality: int = 90) -> tuple:
    """(luma, chroma) quant tables in ZIGZAG order for an IJG-style
    quality factor 1..100 (Annex K tables, libjpeg scaling)."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = []
    for base in (_STD_QT_LUMA, _STD_QT_CHROMA):
        t = np.clip((base * scale + 50) // 100, 1, 255)
        out.append(t[ZIGZAG].astype(np.uint16))
    return out[0], out[1]


def _norm_sampling(s) -> str:
    """Accept the legacy bool (True=4:2:0, False=4:4:4) or an explicit
    '420' / '422' / '444' / 'gray' string."""
    if s is True:
        return "420"
    if s is False:
        return "444"
    s = str(s)
    if s not in ("420", "422", "444", "gray"):
        raise ValueError(f"unsupported chroma sampling {s!r}")
    return s


def _chroma_dims(h: int, w: int, sampling: str) -> tuple:
    if sampling == "420":
        return (h + 1) // 2, (w + 1) // 2
    if sampling == "422":
        return h, (w + 1) // 2
    return h, w


def _src_format(sampling: str) -> PixelFormat:
    return {
        "420": PixelFormat.YUV420,
        "422": PixelFormat.YUV422,
        "444": PixelFormat.YUV444,
        "gray": PixelFormat.Y,
    }[sampling]


def encode_geometry(h: int, w: int, sampling) -> tuple:
    """Block-grid geometry ``((bh_y, bw_y), (bh_c, bw_c), (h, w),
    sampling)`` with the entropy coder's MCU padding rules
    (io/native/jpeg.cpp finish_geometry). ``sampling``: '420' / '422' /
    '444' / 'gray' (or the legacy bool)."""
    sampling = _norm_sampling(sampling)
    sx = 2 if sampling in ("420", "422") else 1
    sy = 2 if sampling == "420" else 1
    mcux = (w + 8 * sx - 1) // (8 * sx)
    mcuy = (h + 8 * sy - 1) // (8 * sy)
    chroma = (0, 0) if sampling == "gray" else (mcuy, mcux)
    return ((mcuy * sy, mcux * sx), chroma, (h, w), sampling)


@lru_cache(maxsize=32)
def _basis(qt: tuple, forward: bool, device: torch.device) -> torch.Tensor:
    """The float32 basis of one quant table on ``device``, built once per
    (table, direction, device) and copied there pinned and non-blocking."""
    fn = fdct_quant_basis if forward else dequant_idct_basis
    return to_device(torch.from_numpy(fn(np.asarray(qt, np.uint16),
                                         np.float32)), device)


def _qt_tuple(q) -> tuple:
    return tuple(int(x) for x in list(q)[:64])


def _coeff_tensor(c, device: torch.device) -> torch.Tensor:
    """A coefficient batch (numpy or tensor) as an int16 tensor on
    ``device``; host data by a pinned non-blocking copy."""
    if isinstance(c, torch.Tensor):
        return c.to(device, torch.int16, non_blocking=True)
    return to_device(np.ascontiguousarray(c, np.int16), device)


# ---- the inverse half -------------------------------------------------------


def _assemble(pix: torch.Tensor, bh: int, bw: int, h: int, w: int):
    """[..., bh*bw, 64] block pixels → [..., h, w] plane (crop the MCU
    padding)."""
    lead = pix.shape[:-2]
    p = pix.reshape(*lead, bh, bw, 8, 8).transpose(-3, -2)
    return p.reshape(*lead, bh * 8, bw * 8)[..., :h, :w]


def _plane_from_coeffs(c, b, bh: int, bw: int, ph: int, pw: int):
    """int16 [N, blocks, 64] coefficients → u8 [N, ph, pw] plane: the
    float32 product by the basis, +128, clipped, rounded half to even."""
    pix = torch.matmul(c.to(torch.float32), b) + 128.0
    return _round_u8(_assemble(pix, bh, bw, ph, pw))


def _decode_planes(coeffs, bases, geometry) -> tuple:
    (bhy, bwy), (bhc, bwc), (h, w), sampling = geometry
    ch, cw = _chroma_dims(h, w, sampling)
    grids = ((bhy, bwy, h, w), (bhc, bwc, ch, cw), (bhc, bwc, ch, cw))
    return tuple(_plane_from_coeffs(c, b, *g)
                 for c, b, g in zip(coeffs, bases, grids))


class JpegDevicePipeline:
    """Configured coefficients → pixels pipeline for one stream geometry.

    Built from a probe (``io.jpeg.JpegCoefDecoder.info`` or a snapshot of
    it): captures the block grids and quant tables; call with int16
    coefficient batches [N, nblocks, 64] (zigzag) per component, numpy or
    tensors.

    ``output='planes'`` returns the decoded u8 (y, u, v) planes (just
    (y,) for grayscale); the ``rgb_u8`` / ``rgb_f32`` / ``normalized`` /
    ``normalized_nchw`` modes resize + convert them (full-range BT.601,
    the JPEG convention) through :class:`~.fused.FusedPipeline`, whose
    CUDA band kernel takes even-sized 4:2:0 planes on the card.

    ``augment``: an :class:`~.augment.AugmentSpec` applies crop / flip /
    jitter in the post-processing (fused modes only), with per-clip params
    from ``counter_seed(seed, epoch, batch_index)``: call with
    ``epoch=`` / ``batch_index=``.

    ``device``: CUDA by default; ``"cpu"`` runs on the CPU.
    """

    def __init__(self, info, out_size=None, method: str = "lanczos",
                 output: str = "rgb_u8", compute: str = "auto",
                 augment=None, clip_len: int = 1, seed: int = 0,
                 device=None):
        if augment is not None:
            from .augment import AugmentSpec

            if not isinstance(augment, AugmentSpec):
                raise TypeError(
                    f"augment must be an AugmentSpec, got {type(augment)!r}")
            if output == "planes":
                raise ValueError(
                    "augment= needs a fused output mode, not 'planes'")
            if compute == "split_bf16":
                raise ValueError(
                    "compute='split_bf16' is not available with augment=")
        self.augment = augment
        self.clip_len = int(clip_len)
        self.seed = int(seed) & 0xFFFFFFFF
        if info.ncomp not in (1, 3):
            raise ValueError(
                f"device JPEG path needs 1 or 3 components, got {info.ncomp}")
        if info.ncomp == 1:
            if (info.hs[0], info.vs[0]) != (1, 1):
                raise ValueError("grayscale JPEG with sampling != 1x1")
            sampling = "gray"
        else:
            hs = [int(info.hs[c]) for c in range(3)]
            vs = [int(info.vs[c]) for c in range(3)]
            if (hs[1], vs[1]) != (1, 1) or (hs[2], vs[2]) != (1, 1):
                raise ValueError(f"unsupported chroma sampling {hs}x{vs}")
            sampling = {(2, 2): "420", (2, 1): "422",
                        (1, 1): "444"}.get((hs[0], vs[0]))
            if sampling is None:
                raise ValueError(
                    f"unsupported luma sampling {hs[0]}x{vs[0]}")
        self.height, self.width = int(info.height), int(info.width)
        if sampling == "420" and (self.height % 2 or self.width % 2):
            raise ValueError(
                "odd-dimension 4:2:0 JPEG unsupported on the device path")
        if sampling == "422" and self.width % 2:
            raise ValueError(
                "odd-width 4:2:2 JPEG unsupported on the device path")
        self.sampling = sampling
        self.ncomp = 1 if sampling == "gray" else 3
        chroma_grid = (0, 0) if sampling == "gray" else (
            int(info.bh[1]), int(info.bw[1]))
        self.geometry = ((int(info.bh[0]), int(info.bw[0])), chroma_grid,
                         (self.height, self.width), sampling)
        self.out_h, self.out_w = out_size or (self.height, self.width)
        self.method, self.output, self.compute = method, output, compute
        self.device = resolve_device(device)
        self._post = None
        if augment is not None:
            from .augment import AugmentPipeline

            self._post = AugmentPipeline(
                _src_format(sampling), ColorSpace.BT_601, ColorRange.JPEG,
                out_size=(self.out_w, self.out_h), spec=augment,
                clip_len=self.clip_len, method=method, output=output,
                seed=self.seed, device=self.device)
        elif output != "planes":
            from .fused import FusedPipeline

            self._post = FusedPipeline(
                _src_format(sampling), ColorSpace.BT_601, ColorRange.JPEG,
                (self.out_w, self.out_h), method=method, output=output,
                device=self.device, kernel="auto", compute=compute)
        self.set_quant_tables(info)

    def set_quant_tables(self, info) -> None:
        """(Re)bind the dequant+IDCT bases of ``info``'s tables (the ctypes
        probe struct or a snapshot with per-component ``qt``)."""
        self._qt = tuple(_qt_tuple(info.qt[c]) for c in range(self.ncomp))
        self._bases = tuple(_basis(q, False, self.device) for q in self._qt)

    def quant_changed(self, info) -> bool:
        return any(_qt_tuple(info.qt[c]) != self._qt[c]
                   for c in range(self.ncomp))

    def planes(self, *coeffs) -> tuple:
        """The decoded u8 planes of coefficient batches on this device."""
        if len(coeffs) != self.ncomp:
            raise ValueError(
                f"expected {self.ncomp} coefficient batches, got "
                f"{len(coeffs)}")
        cs = [_coeff_tensor(c, self.device) for c in coeffs]
        check_f32_matmul(cs[0], "JpegDevicePipeline")
        return _decode_planes(cs, self._bases, self.geometry)

    def __call__(self, *coeffs, epoch: int = 0, batch_index: int = 0):
        planes = self.planes(*coeffs)
        if self._post is None:
            return planes
        if self.augment is not None:
            return self._post(*planes, epoch=epoch, batch_index=batch_index)
        return self._post(*planes)


# ---- the forward half -------------------------------------------------------


def _blockify(p: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """[..., ph, pw] plane → [..., bh*bw, 64] row-major pixel blocks,
    edge-replicating into the MCU padding (the encoder-side fill that
    keeps padded-block coefficients small)."""
    lead = p.shape[:-2]
    ph, pw = p.shape[-2], p.shape[-1]
    if (ph, pw) != (bh * 8, bw * 8):
        rows = torch.arange(bh * 8, device=p.device).clamp_(max=ph - 1)
        cols = torch.arange(bw * 8, device=p.device).clamp_(max=pw - 1)
        p = p.index_select(-2, rows).index_select(-1, cols)
    p = p.reshape(*lead, bh, 8, bw, 8).transpose(-3, -2)
    return p.reshape(*lead, bh * bw, 64)


def _coeffs_from_plane(p, a, bh: int, bw: int) -> torch.Tensor:
    """u8 plane → int16 zigzag coefficients: level shift, the float32
    product by the forward basis, rounded half to even, clipped to
    ±2047."""
    blk = _blockify(p, bh, bw).to(torch.float32) - 128.0
    c = torch.matmul(blk, a)
    return torch.clamp(torch.round(c), -2047.0, 2047.0).to(torch.int16)


def _encode_coeffs(planes, bases, geometry) -> tuple:
    (bhy, bwy), (bhc, bwc), _, _ = geometry
    grids = ((bhy, bwy), (bhc, bwc), (bhc, bwc))
    return tuple(_coeffs_from_plane(p, a, *g)
                 for p, a, g in zip(planes, bases, grids))


def _forward_bases(quality, quant_tables, ncomp, device) -> tuple:
    """((luma, chroma) zigzag tables as uint16, the per-component forward
    bases on ``device``)."""
    if quant_tables is None:
        quant_tables = std_quant_tables(quality)
    ql, qc = (np.asarray(t, np.uint16).reshape(64) for t in quant_tables)
    tables = (ql,) if ncomp == 1 else (ql, qc, qc)
    return (ql, qc), tuple(_basis(_qt_tuple(t), True, device) for t in tables)


class JpegDeviceEncoder:
    """Batched frames → quantized DCT coefficients on the device.

    The mirror of :class:`JpegDevicePipeline`: the optional resize, RGB →
    YCbCr (full-range BT.601), the 4:2:0 chroma fold, level shift,
    forward DCT and quantization run as float32 matmuls on the device;
    the serial Huffman coding runs on the host
    (``io.jpeg.JpegCoefEncoder``).

    ``encode_rgb`` takes (N, H, W, 3) u8 RGB of any size (through
    ``encode_feed``, or ``encode_feed_gray`` for a gray target);
    ``encode_planes`` takes u8 (y, u, v) planes at the target geometry.
    """

    def __init__(self, height: int, width: int, quality: int = 90,
                 subsampled=True, quant_tables=None,
                 method: str = "lanczos", device=None):
        sampling = _norm_sampling(subsampled)
        if sampling == "420" and (height % 2 or width % 2):
            raise ValueError("4:2:0 JPEG target size must be even")
        if sampling == "422" and width % 2:
            raise ValueError("4:2:2 JPEG target width must be even")
        self.height, self.width = int(height), int(width)
        self.sampling = sampling
        self.subsampled = sampling == "420"  # legacy flag
        self.ncomp = 1 if sampling == "gray" else 3
        self.method = method
        self.device = resolve_device(device)
        self.geometry = encode_geometry(self.height, self.width, sampling)
        self.quant_tables, self._bases = _forward_bases(
            quality, quant_tables, self.ncomp, self.device)

    def encode_planes(self, *planes) -> tuple:
        """u8 planes [N, h, w] (+ [N, ch, cw] chroma unless grayscale) →
        int16 zigzag coefficient batches [N, blocks, 64] per component."""
        if len(planes) != self.ncomp:
            raise ValueError(
                f"expected {self.ncomp} planes, got {len(planes)}")
        ps = [to_device(p, self.device) for p in planes]
        check_f32_matmul(ps[0], "JpegDeviceEncoder")
        return _encode_coeffs(ps, self._bases, self.geometry)

    def encode_rgb(self, rgb) -> tuple:
        """(N, H, W, 3) u8 RGB (or float in [0, 1]) → coefficient batches,
        resized to the target size first. Grayscale targets keep the
        luma only."""
        if self.sampling not in ("420", "gray"):
            raise ValueError(
                "encode_rgb emits 4:2:0 (encode_feed); use encode_planes "
                f"for 4:{'4:4' if self.sampling == '444' else '2:2'} input")
        from .fused import encode_feed, encode_feed_gray

        kw = dict(out_h=self.height, out_w=self.width,
                  space=ColorSpace.BT_601, rng=ColorRange.JPEG,
                  method=self.method, device=self.device)
        if self.sampling == "gray":
            return self.encode_planes(encode_feed_gray(rgb, **kw))
        return self.encode_planes(*encode_feed(rgb, **kw))

    __call__ = encode_rgb


# ---- the transcoder ---------------------------------------------------------


class JpegDeviceTranscoder:
    """The device half of the split MJPEG→MJPEG transcoder: coefficients
    in, coefficients out.

    Dequant + IDCT (the source tables) → u8 planes → an optional
    per-plane resize that stays in YUV (float32 matmuls, rounded back to
    u8) → level shift + forward DCT + requant (the destination tables).
    The u8 clamp between the halves keeps decode-then-reencode semantics,
    so the two 64×64 matrices are not folded into one.

    Source geometry and tables come from a probe; destination tables from
    ``quality`` (Annex K scaling) or ``quant_tables``; ``out_size=(h, w)``
    resizes (4:2:0 sizes must be even). The output keeps the source's
    sampling. ``compute``: 'auto' / 'highest' are float32, 'split_bf16'
    the JAX package's hi/lo bf16 resize numerics.
    """

    def __init__(self, info, quality: int = 90, out_size=None,
                 quant_tables=None, method: str = "lanczos",
                 compute: str = "auto", device=None):
        # the decode pipeline's probe validation and geometry rules
        probe = JpegDevicePipeline(info, output="planes", device=device)
        self.device = probe.device
        self.src_geometry = probe.geometry
        self.sampling = probe.sampling
        self.subsampled = self.sampling == "420"  # legacy flag
        self.ncomp = probe.ncomp
        self.height, self.width = probe.height, probe.width
        self.out_h, self.out_w = out_size or (self.height, self.width)
        if self.sampling == "420" and (self.out_h % 2 or self.out_w % 2):
            raise ValueError("4:2:0 JPEG target size must be even")
        if self.sampling == "422" and self.out_w % 2:
            raise ValueError("4:2:2 JPEG target width must be even")
        self.dst_geometry = encode_geometry(self.out_h, self.out_w,
                                            self.sampling)
        self.method, self.compute = method, compute
        self.quant_tables, self._fwd = _forward_bases(
            quality, quant_tables, self.ncomp, self.device)
        self.set_src_quant_tables(info)

    def set_src_quant_tables(self, info) -> None:
        """(Re)bind the inverse bases on a mid-stream DQT change. Accepts
        a probe info (``.qt``) or a per-component sequence of 64-entry
        zigzag tables."""
        qts = info if isinstance(info, (tuple, list)) else [
            info.qt[c] for c in range(self.ncomp)]
        self._inv = tuple(_basis(_qt_tuple(q), False, self.device)
                          for q in qts)

    def _resized(self, p: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
        from .fused import _resize_matrices, _resize_plane2d

        ih, iw = p.shape[-2], p.shape[-1]
        if (ih, iw) == (oh, ow):
            return p
        rmat, cmat = _resize_matrices(ih, iw, oh, ow, self.method, p.device)
        mode = "split_bf16" if self.compute == "split_bf16" else "highest"
        return _round_u8(_resize_plane2d(p, rmat, cmat, mode))

    def __call__(self, *coeffs) -> tuple:
        """[N, blocks, 64] int16 zigzag batches per component → the same
        at the output geometry and tables."""
        if len(coeffs) != self.ncomp:
            raise ValueError(
                f"expected {self.ncomp} coefficient batches, got "
                f"{len(coeffs)}")
        cs = [_coeff_tensor(c, self.device) for c in coeffs]
        check_f32_matmul(cs[0], "JpegDeviceTranscoder")
        planes = _decode_planes(cs, self._inv, self.src_geometry)
        dh, dw = self.out_h, self.out_w
        dims = ((dh, dw),) + (_chroma_dims(dh, dw, self.sampling),) * 2
        planes = [self._resized(p, *d) for p, d in zip(planes, dims)]
        return _encode_coeffs(planes, self._fwd, self.dst_geometry)


# ---- float64 goldens --------------------------------------------------------


def golden_encode(planes, qts, geometry) -> tuple:
    """float64 reference for the forward path: u8 (y, u, v) planes →
    int16 zigzag coefficient batches (rint rounding) — the fidelity
    anchor for :class:`JpegDeviceEncoder`."""
    (bhy, bwy), (bhc, bwc), (_h, _w), _sub = geometry
    grids = ((bhy, bwy), (bhc, bwc), (bhc, bwc))
    out = []
    for p, qt, (bh, bw) in zip(planes, qts, grids):
        a = fdct_quant_basis(qt, np.float64)
        lead = p.shape[:-2]
        ph, pw = p.shape[-2], p.shape[-1]
        pad = [(0, 0)] * len(lead) + [(0, bh * 8 - ph), (0, bw * 8 - pw)]
        blk = np.pad(p, pad, mode="edge").astype(np.float64)
        blk = blk.reshape(*lead, bh, 8, bw, 8).swapaxes(-3, -2)
        blk = blk.reshape(*lead, bh * bw, 64) - 128.0
        out.append(np.clip(np.rint(blk @ a), -2047, 2047).astype(np.int16))
    return tuple(out)


def golden_decode(coeffs, qts, geometry) -> tuple:
    """float64 reference: the decoded u8 (y, u, v) planes from zigzag
    coefficient batches — the fidelity anchor for the device pipeline
    (rint rounding)."""
    (bhy, bwy), (bhc, bwc), (h, w), sampling = geometry
    grids = ((bhy, bwy), (bhc, bwc), (bhc, bwc))
    dims = ((h, w),) + (_chroma_dims(h, w, _norm_sampling(sampling)),) * 2
    out = []
    for c, qt, (bh, bw), (ph, pw) in zip(coeffs, qts, grids, dims):
        b = dequant_idct_basis(qt, np.float64)
        pix = np.asarray(c).astype(np.float64) @ b + 128.0
        lead = pix.shape[:-2]
        p = pix.reshape(*lead, bh, bw, 8, 8).swapaxes(-3, -2)
        p = p.reshape(*lead, bh * 8, bw * 8)[..., :ph, :pw]
        out.append(np.clip(np.rint(p), 0, 255).astype(np.uint8))
    return tuple(out)
