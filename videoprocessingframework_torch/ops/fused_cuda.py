"""Fused YUV420/NV12 u8 → Lanczos/bilinear/nearest resize → CSC → planar
RGB: the CUDA kernel's wrapper, its band plan, its plain PyTorch version
and its gate.

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

The kernel runs one block per (frame, band of output rows, tile of output
columns). :func:`band_plan` cuts the output into bands and tiles that fit
shared memory, lists the source rows each band needs and the bytes of
each row each tile needs, and lays out the block's shared memory;
:func:`copy_width` picks the widest copy the planes' pointers and strides
allow. ``_direct_resize_rgb`` launches the first version of the kernel
(one thread per output pixel), kept as the same-call baseline.

Dispatch: a CPU tensor takes :func:`fused_yuv420_resize_rgb_ref` /
:func:`fused_nv12_resize_rgb_ref` (dense float32 matmuls, same CSC and
store); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..csrc.launch import launch, ptr
from . import colorspace as cs
from .colorspace import f32
from .resize import SUPPORTED, chroma_collapse, resize_matrix

OUTPUTS = ("rgb_u8", "rgb_f32", "normalized")
_MODE = {"rgb_u8": 0, "rgb_f32": 1, "normalized": 2}

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


# ---- band plan -----------------------------------------------------------------

#: shared memory one block may use on Hopper, and the budgets that let
#: five, four, three or two blocks sit on one SM (228 KB per SM, 1 KB of
#: it reserved per block)
SMEM_MAX = 232_448
SMEM_BUDGETS = tuple(233_472 // n - 1024 for n in (5, 4, 3, 2)) + (SMEM_MAX,)
#: luma rows a plan may stage twice (bands overlap where windows do), as a
#: share of the rows the resize reads
MAX_HALO = 0.05
#: row and column taps the kernel holds (luma, half-grid chroma)
KY_MAX, KC_MAX = 6, 4
MAX_COLS = 112      # output columns per tile, one consumer thread each
MAX_THREADS = 512   # threads per block: the consumers, then the producers
MAX_ROWS = 8        # output rows per band
#: blocks per SM the grid should hold where shorter bands can give them: a
#: block copies and sums its chunks in turn, so a grid of a few blocks per
#: SM leaves the card waiting on each block's latency
MIN_BLOCKS_PER_SM = 3
CHUNK_BYTES = 16384  # source bytes per staged chunk to aim for
MAX_CHUNK = 8       # source rows per staged chunk, at most
#: ring depth and producer warps, compiled into the kernel
#: (csrc/fused_resize_csc.cu: STAGES, PRODUCERS)
STAGES, PRODUCERS = 2, 2
#: bytes past its span that each staged row's pitch holds: a window's three
#: 4-byte loads may end 11 bytes past the span (the kernel's window8)
ROW_PAD = 16
#: the plan's scalars in the order the C entry point reads them
#: (csrc/fused_resize_csc.cu: PlanField)
PLAN_FIELDS = ("rows", "cols", "n_bands", "n_tiles", "chunk", "vec_y",
               "vec_c", "pitch_y", "pitch_c", "stage_bytes", "band_stride",
               "max_rows_y", "off_hy", "off_hu", "off_hv", "off_tab",
               "tab_words", "off_rows", "off_bar", "smem", "threads")


def copy_width(ptrs: Sequence[int], strides: Sequence[int],
               row_bytes: int) -> int:
    """Widest copy, of 16, 8, 4, 2 or 1 bytes, that divides every base
    pointer, every stride and the row's length in bytes: a staged span
    aligned to it then never leaves its row. cp.async takes 16, 8 or 4;
    the kernel stages narrower widths with plain loads."""
    for vec in (16, 8, 4, 2):
        if all(int(x) % vec == 0 for x in (*ptrs, *strides, row_bytes)):
            return vec
    return 1


@dataclass(frozen=True, eq=False)
class BandPlan:
    """How the kernel cuts one resize: a block per (frame, band of ``rows``
    output rows, tile of ``cols`` output columns).

    ``band_rows[n]`` = (luma count, chroma count, the band's sorted luma
    source rows padded to ``max_rows_y``, its chroma rows): the union of
    its output rows' tap windows, each row staged once. ``row_pos[0|1, oy]``
    is the position of output row oy's luma | chroma window start in its
    band's list (a window's rows sit next to each other there).
    ``band_tab[n]`` (int32 words, ``tab_words`` of them) is what the
    vertical pass reads of band n: its row weights padded to 8 luma and 4
    chroma per output row (float32 bits), then its rows' luma and chroma
    window positions.
    ``tile_cols[t]`` = (luma lo, luma bytes, chroma lo, chroma bytes): the
    staged span of a source row, aligned to the copy width (NV12: bytes of
    the interleaved UV row). Shared memory, in bytes from 0: ``STAGES``
    chunk buffers of ``stage_bytes`` (``chunk`` rows at ``pitch_y``, or
    ``chunk`` U then ``chunk`` V rows at ``pitch_c``; NV12: UV rows), then
    H for luma, U and V (float32, ``cols`` wide), the band's table
    (16-byte aligned), the band's source row lists (``band_rows[n][2:]``)
    and the ring's mbarriers (full and empty per slot, then one for the
    table; 8 bytes each). A pitch is the widest span rounded up to 16
    bytes, plus ``ROW_PAD``: a window's bytes are read as three 4-byte
    loads from the 4-byte boundary below it, and those stay inside the
    row. A block's last ``PRODUCERS`` warps copy; the ``threads - 32 *
    PRODUCERS`` threads before them take one output column each.
    """

    rows: int
    cols: int
    n_bands: int
    n_tiles: int
    chunk: int
    vec_y: int
    vec_c: int
    pitch_y: int
    pitch_c: int
    stage_bytes: int
    band_stride: int
    max_rows_y: int
    max_rows_c: int
    off_hy: int
    off_hu: int
    off_hv: int
    off_tab: int
    tab_words: int
    off_rows: int
    off_bar: int
    smem: int
    threads: int
    band_rows: np.ndarray
    row_pos: np.ndarray
    band_tab: np.ndarray
    tile_cols: np.ndarray

    def fields(self):
        return [getattr(self, f) for f in PLAN_FIELDS]


def _up(x: int, n: int) -> int:
    return -(-x // n) * n


def _band_rows(start: np.ndarray, k: int, rows: int):
    """Per band of ``rows`` output rows: the sorted source rows its tap
    windows cover, and each output row's window start as a position in
    that list."""
    lists, pos = [], np.empty(len(start), np.int32)
    for oy0 in range(0, len(start), rows):
        st = start[oy0:oy0 + rows].astype(np.int64)
        need = np.unique((st[:, None] + np.arange(k)).ravel())
        pos[oy0:oy0 + rows] = np.searchsorted(need, st)
        lists.append(need)
    return lists, pos


def _tile_cols(start: np.ndarray, k: int, cols: int, step: int,
               vec: int) -> np.ndarray:
    """Per tile of ``cols`` output columns: (lo, bytes) of the source row
    span its windows cover, widened to multiples of ``vec``."""
    spans = []
    for ox0 in range(0, len(start), cols):
        st = start[ox0:ox0 + cols]
        lo = int(st.min()) * step
        hi = (int(st.max()) + k) * step
        lo -= lo % vec
        spans.append((lo, _up(hi, vec) - lo))
    return np.asarray(spans, np.int32)


def _band_tab(rwy, rwc, pos_y, pos_c, rows, words) -> np.ndarray:
    """Per band: its row weights, padded to 8 (luma) and 4 (chroma) per
    output row, as float32 bits, then its luma and chroma window
    positions."""
    out_h = len(rwy)
    n_bands = -(-out_h // rows)
    tab = np.zeros((n_bands, words), np.int32)
    wts = tab[:, :rows * 12].view(np.float32)
    for oy in range(out_h):
        n, t = divmod(oy, rows)
        wts[n, t * 8:t * 8 + rwy.shape[1]] = rwy[oy]
        wts[n, rows * 8 + t * 4:rows * 8 + t * 4 + rwc.shape[1]] = rwc[oy]
        tab[n, rows * 12 + t] = pos_y[oy]
        tab[n, rows * 13 + t] = pos_c[oy]
    return tab


@lru_cache(maxsize=64)
def band_plan(h: int, w: int, out_h: int, out_w: int,
              method: str = "lanczos", step: int = 1, vec_y: int = 16,
              vec_c: int = 16, min_bands: int = 1) -> BandPlan:
    """Plan the band kernel for one shape, chroma step (1 planar, 2 NV12)
    and pair of copy widths, in at least ``min_bands`` bands where bands of
    one row or more allow it (the wrapper asks for the bands that give its
    grid ``MIN_BLOCKS_PER_SM`` blocks per SM).

    Tiles split the output width evenly into at most ``MAX_COLS`` columns;
    a chunk holds about ``CHUNK_BYTES`` of source rows (1 to
    ``MAX_CHUNK``). The plan takes the most output rows per band (up to
    ``MAX_ROWS`` and ``out_h // min_bands``) whose shared memory lets five
    blocks share an SM, else four, three, two or one, narrowing the tiles
    where even one band row does not fit; it raises where nothing fits.
    First it looks only at
    bands that restage at most ``MAX_HALO`` of the luma rows. (More blocks
    per SM hide more of each block's copy and sum latency, and a band's
    overlap with the next is read twice.)
    """
    if step not in (1, 2):
        raise ValueError(f"chroma step must be 1 or 2, got {step}")
    tabs = tap_tables(h, w, out_h, out_w, method)
    (rsy, rwy), (rsc, rwc) = tabs["rows_y"], tabs["rows_c"]
    (csy, cwy), (csc, cwc) = tabs["cols_y"], tabs["cols_c"]
    ky, kc = rwy.shape[1], rwc.shape[1]
    if max(ky, cwy.shape[1]) > KY_MAX or max(kc, cwc.shape[1]) > KC_MAX:
        raise ValueError(
            f"{h}x{w}->{out_h}x{out_w} ({method}) needs more taps than the "
            f"kernel holds ({KY_MAX} luma, {KC_MAX} chroma)"
        )
    bands = {}  # rows per band -> (luma lists, positions, chroma ...)

    def band_lists(rows):
        if rows not in bands:
            bands[rows] = _band_rows(rsy, ky, rows) + _band_rows(rsc, kc, rows)
        return bands[rows]

    needed = len(np.unique(rsy[:, None] + np.arange(ky)))  # luma rows read
    top = max(1, min(MAX_ROWS, out_h // max(1, min_bands)))
    for halo in (MAX_HALO, None):
        for budget in SMEM_BUDGETS:
            for n_tiles in range(-(-out_w // MAX_COLS), out_w + 1):
                cols = -(-out_w // n_tiles)
                if -(-out_w // cols) != n_tiles:
                    continue  # the same tiles as a smaller count
                ty = _tile_cols(csy, cwy.shape[1], cols, 1, vec_y)
                tc = _tile_cols(csc, cwc.shape[1], cols, step, vec_c)
                pitch_y = _up(int(ty[:, 1].max()), 16) + ROW_PAD
                pitch_c = _up(int(tc[:, 1].max()), 16) + ROW_PAD
                row_bytes = max(pitch_y, pitch_c * (2 if step == 1 else 1))
                n_chunk = max(1, min(MAX_CHUNK, CHUNK_BYTES // row_bytes))
                stage_bytes = n_chunk * row_bytes
                for rows in range(top, 0, -1):
                    ly, py, lc, pc = band_lists(rows)
                    if halo is not None and \
                            sum(map(len, ly)) > (1 + halo) * needed:
                        continue
                    my = max(len(r) for r in ly)
                    mc = max(len(r) for r in lc)
                    off_hy = STAGES * stage_bytes
                    off_hu = off_hy + 4 * my * cols
                    off_hv = off_hu + 4 * mc * cols
                    off_tab = _up(off_hv + 4 * mc * cols, 16)
                    tab_words = _up(rows * (8 + 4 + 2), 4)
                    off_rows = off_tab + 4 * tab_words
                    off_bar = _up(off_rows + 4 * (my + mc), 8)
                    smem = off_bar + 8 * (2 * STAGES + 1)
                    if smem > budget:
                        continue
                    band_rows = np.zeros((len(ly), 2 + my + mc), np.int32)
                    for n, (ry, rc) in enumerate(zip(ly, lc)):
                        band_rows[n, :2] = len(ry), len(rc)
                        band_rows[n, 2:2 + len(ry)] = ry
                        band_rows[n, 2 + my:2 + my + len(rc)] = rc
                    return BandPlan(
                        rows=rows, cols=cols, n_bands=len(ly),
                        n_tiles=n_tiles, chunk=n_chunk, vec_y=vec_y,
                        vec_c=vec_c, pitch_y=pitch_y, pitch_c=pitch_c,
                        stage_bytes=stage_bytes,
                        band_stride=2 + my + mc, max_rows_y=my,
                        max_rows_c=mc, off_hy=off_hy, off_hu=off_hu,
                        off_hv=off_hv, off_tab=off_tab, tab_words=tab_words,
                        off_rows=off_rows, off_bar=off_bar, smem=smem,
                        threads=_up(cols, 32) + 32 * PRODUCERS,
                        band_rows=band_rows, row_pos=np.stack([py, pc]),
                        band_tab=_band_tab(rwy, rwc, py, pc, rows, tab_words),
                        tile_cols=np.concatenate([ty, tc], axis=1),
                    )
    raise ValueError(
        f"no band plan for {h}x{w}->{out_h}x{out_w} ({method}, chroma step "
        f"{step}) fits {SMEM_MAX} bytes of shared memory"
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


@lru_cache(maxsize=64)
def _device_plan(plan: BandPlan, device: torch.device):
    """A plan's row lists, band tables and tile spans on the device (int32;
    the tile spans are read as one 16-byte int4 per tile)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                 .to(device)
                 for a in (plan.band_rows, plan.band_tab, plan.tile_cols))


@lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _planar_chroma(y, u, v, output):
    _check(y, (u, v), 1, output)
    if u.stride() != v.stride():
        raise ValueError("u and v planes must share one layout")
    return (u.data_ptr(), v.data_ptr()), 1, u.stride()


def _nv12_chroma(y, uv, output):
    _check(y, (uv,), 2, output)
    # U and V interleave: element step 2 within a row, V one byte on
    base = uv.data_ptr()
    return (base, base + 1), 2, (uv.stride(0), uv.stride(1),
                                 2 * uv.stride(2))


def _plan(y, c_ptrs, step, cstrides, out_h, out_w, method) -> BandPlan:
    """The band plan for these planes: copy widths from their pointers and
    strides, and bands enough for MIN_BLOCKS_PER_SM blocks per SM in the
    batch's grid."""
    b, h, w = y.shape
    n = 0 if b > 1 else 1  # the batch stride matters only for a 2nd frame
    vec_y = copy_width((y.data_ptr(),), (y.stride(0), y.stride(1))[n:], w)
    vec_c = copy_width(c_ptrs[:3 - step], cstrides[n:2], (w // 2) * step)
    min_bands = -(-MIN_BLOCKS_PER_SM * _sm_count(y.device)
                  // (max(b, 1) * -(-out_w // MAX_COLS)))
    return band_plan(h, w, out_h, out_w, method, step, vec_y, vec_c,
                     min_bands)


def plan_for(y, *chroma, out_h: int, out_w: int,
             method: str = "lanczos") -> BandPlan:
    """The plan the band kernel takes for CUDA planes: (y, u, v) planar or
    (y, uv) NV12."""
    layout = _planar_chroma if len(chroma) == 2 else _nv12_chroma
    return _plan(y, *layout(y, *chroma, "rgb_u8"), out_h, out_w, method)


def _launch(y, c_ptrs, step, cstrides, *, out_h, out_w, space, rng, method,
            swap, output, mean, std, direct=False):
    """Launch the kernel on the current stream; chroma as two base
    pointers (NV12: the UV plane and one byte on) with (batch, row,
    element) strides in bytes. ``direct`` launches the first version
    instead, counted under its own name."""
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
    if not direct:
        plan = _plan(y, c_ptrs, step, cstrides, out_h, out_w, method)
    tabs = _device_tables(h, w, out_h, out_w, method, y.device)
    m, off, mean32, inv_std = _csc_consts(space, rng, swap, mean, std)
    csc = (ctypes.c_float * 18)(
        *np.concatenate([m.ravel(), off, mean32, inv_std]).tolist()
    )
    dtype = torch.uint8 if output == "rgb_u8" else torch.float32
    out = torch.empty((b, 3, out_h, out_w), dtype=dtype, device=y.device)
    if b == 0:
        return out
    args = [ptr(y), ctypes.c_void_p(c_ptrs[0]), ctypes.c_void_p(c_ptrs[1]),
            step, b, y.stride(0), y.stride(1), cstrides[0], cstrides[1]]
    for k in ("rows_y", "rows_c", "cols_y", "cols_c"):
        s, wt, kk = tabs[k]
        args += [ptr(s), ptr(wt), kk]
    args += [ptr(out), out_h, out_w, _MODE[output], csc]
    if direct:
        launch("fused_resize_csc_direct", y.device, *args)
    else:
        fields = (ctypes.c_int32 * len(PLAN_FIELDS))(*plan.fields())
        launch("fused_resize_csc", y.device, *args, fields,
               *map(ptr, _device_plan(plan, y.device)))
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
    return _launch(y, *_planar_chroma(y, u, v, output), **kw)


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
    return _launch(y, *_nv12_chroma(y, uv, output), **kw)


def _direct_resize_rgb(y, *chroma, out_h: int, out_w: int,
                       space=ColorSpace.BT_709, rng=ColorRange.MPEG,
                       method: str = "lanczos", swap: bool = False,
                       output: str = "rgb_u8",
                       mean: Sequence[float] = (0.0, 0.0, 0.0),
                       std: Sequence[float] = (1.0, 1.0, 1.0)):
    """The kernel's first version (one thread per output pixel) on CUDA
    planes: (y, u, v) planar or (y, uv) NV12. The baseline that
    chip_smoke.py and the card tests hold the band kernel to (equal
    outputs, a slower time); no path of the package calls it."""
    kw = dict(out_h=out_h, out_w=out_w, space=space, rng=rng, method=method,
              swap=swap, output=output, mean=mean, std=std)
    layout = _planar_chroma if len(chroma) == 2 else _nv12_chroma
    return _launch(y, *layout(y, *chroma, output), direct=True, **kw)
