"""The band plan of the fused resize + CSC kernel (ops/fused_cuda.py).

* ``band_plan`` at the kernel's shapes × methods × planar/NV12: every
  output row's and column's tap window lies inside its band's staged rows
  and its tile's staged bytes, every output pixel belongs to exactly one
  block, the shared memory fits the card, and the layout does not overlap.
* ``copy_width`` divides the planes' base offsets and strides, and is the
  widest that does.
* A float32 numpy emulation that follows the plan (stage the listed rows'
  spans, horizontal pass into H, vertical pass from H, CSC, store) agrees
  with the plain version within the kernel's tolerance, and with the JAX
  package's Pallas kernel in interpret mode.
* On the card: the band kernel equals the first version exactly, and a
  launch the card refuses raises.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.core.enums import (
    ColorRange as JColorRange,
    ColorSpace as JColorSpace,
)
from videoprocessingframework_tpu.ops.pallas_fused import (
    fused_yuv420_resize_rgb_pallas,
)
from videoprocessingframework_torch.core.enums import ColorRange, ColorSpace
from videoprocessingframework_torch.csrc import launch
from videoprocessingframework_torch.ops import fused_cuda as fc

# kernel vs plain tolerances (chip_smoke.py TOL): u8 may flip one code at a
# rounding boundary; float outputs carry float32 summation-order noise
TOL = {"rgb_u8": 1.0, "rgb_f32": 2e-5, "normalized": 1e-4}

SHAPES = [(1080, 1920, 224, 224), (2160, 3840, 224, 224),
          (4320, 7680, 224, 224), (464, 848, 61, 45),
          (240, 320, 1080, 1920)]
METHODS = ["lanczos", "bilinear", "nearest"]


def _check_plan(plan, h, w, out_h, out_w, method, step):
    tabs = fc.tap_tables(h, w, out_h, out_w, method)
    # tiles and bands cover every output pixel exactly once
    cover = np.zeros((out_h, out_w), np.int64)
    for n in range(plan.n_bands):
        for t in range(plan.n_tiles):
            cover[n * plan.rows:(n + 1) * plan.rows,
                  t * plan.cols:(t + 1) * plan.cols] += 1
    assert (cover == 1).all()
    assert plan.n_bands * plan.rows >= out_h > (plan.n_bands - 1) * plan.rows
    assert plan.n_tiles * plan.cols >= out_w > (plan.n_tiles - 1) * plan.cols
    assert plan.cols <= fc.MAX_COLS
    assert plan.threads <= fc.MAX_THREADS and plan.threads % 32 == 0
    # one consumer thread per column, then the producer warps
    assert plan.cols <= plan.threads - 32 * fc.PRODUCERS < plan.cols + 32
    # every output row's window lies in its band's row list, in order
    for key, which, k_max in (("rows_y", 0, plan.max_rows_y),
                              ("rows_c", 1, plan.max_rows_c)):
        start, wt = tabs[key]
        k = wt.shape[1]
        for n in range(plan.n_bands):
            br = plan.band_rows[n]
            count = br[which]
            assert 1 <= count <= k_max
            off = 2 + (plan.max_rows_y if which else 0)
            listed = br[off:off + count]
            assert (np.diff(listed) > 0).all()
            for oy in range(n * plan.rows, min(out_h, (n + 1) * plan.rows)):
                pos = plan.row_pos[which, oy]
                assert pos + k <= count
                np.testing.assert_array_equal(listed[pos:pos + k],
                                              start[oy] + np.arange(k))
    # every output column's window lies in its tile's staged bytes
    src_bytes = {"cols_y": w, "cols_c": (w // 2) * step}
    for key, col, st, vec in (("cols_y", 0, 1, plan.vec_y),
                              ("cols_c", 2, step, plan.vec_c)):
        start, wt = tabs[key]
        k = wt.shape[1]
        for t in range(plan.n_tiles):
            lo, nbytes = plan.tile_cols[t, col:col + 2]
            assert lo % vec == 0 and nbytes % vec == 0
            assert lo >= 0 and lo + nbytes <= src_bytes[key]
            pitch = plan.pitch_y if col == 0 else plan.pitch_c
            assert nbytes + fc.ROW_PAD <= pitch and pitch % 16 == 0
            ox = np.arange(t * plan.cols, min(out_w, (t + 1) * plan.cols))
            first = start[ox] * st - lo
            last = (start[ox] + k - 1) * st + (st - 1) - lo
            assert first.min() >= 0 and last.max() < nbytes
            # the kernel reads a window as three 4-byte loads from the
            # 4-byte boundary below it: they stay inside the row's pitch
            assert ((first & ~3) + 12).max() <= pitch
    # shared memory: stages, then H (luma, U, V), the row weights and the
    # window positions
    ky = tabs["rows_y"][1].shape[1]
    kc = tabs["rows_c"][1].shape[1]
    row_bytes = max(plan.pitch_y, plan.pitch_c * (2 if step == 1 else 1))
    assert plan.stage_bytes == plan.chunk * row_bytes
    assert plan.stage_bytes % 16 == 0
    assert plan.off_hy == fc.STAGES * plan.stage_bytes
    assert plan.off_hu == plan.off_hy + 4 * plan.max_rows_y * plan.cols
    assert plan.off_hv == plan.off_hu + 4 * plan.max_rows_c * plan.cols
    assert plan.off_tab % 16 == 0
    assert 0 <= plan.off_tab - (plan.off_hv + 4 * plan.max_rows_c
                                * plan.cols) < 16
    assert plan.tab_words % 4 == 0 and plan.tab_words >= plan.rows * 14
    assert plan.off_bar % 8 == 0
    assert plan.off_rows == plan.off_tab + 4 * plan.tab_words
    assert plan.off_rows + 4 * (plan.band_stride - 2) <= plan.off_bar
    assert plan.smem == plan.off_bar + 8 * (2 * fc.STAGES + 1)
    # the band tables: padded row weights, then the window positions
    (_, rwy), (_, rwc) = tabs["rows_y"], tabs["rows_c"]
    for oy in range(out_h):
        n, t = divmod(oy, plan.rows)
        tab = plan.band_tab[n]
        wts = tab[:plan.rows * 12].view(np.float32)
        np.testing.assert_array_equal(wts[t * 8:t * 8 + ky], rwy[oy])
        assert not wts[t * 8 + ky:t * 8 + 8].any()
        c0 = plan.rows * 8 + t * 4
        np.testing.assert_array_equal(wts[c0:c0 + kc], rwc[oy])
        assert tab[plan.rows * 12 + t] == plan.row_pos[0, oy]
        assert tab[plan.rows * 13 + t] == plan.row_pos[1, oy]
    assert max(ky, tabs["cols_y"][1].shape[1]) <= fc.KY_MAX
    assert max(kc, tabs["cols_c"][1].shape[1]) <= fc.KC_MAX
    assert plan.smem <= 232_448


@pytest.mark.parametrize("layout", ["planar", "nv12"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["1080p", "2160p", "4320p", "464x848", "up"])
def test_band_plan_covers_and_fits(shape, method, layout):
    h, w, out_h, out_w = shape
    step = 1 if layout == "planar" else 2
    plan = fc.band_plan(h, w, out_h, out_w, method, step, 16,
                        8 if (w // 2) % 16 else 16)
    _check_plan(plan, h, w, out_h, out_w, method, step)
    if method == "lanczos" and shape[:2] in ((1080, 1920), (2160, 3840)):
        # the main path's shapes leave room for four blocks per SM
        assert plan.smem <= fc.SMEM_BUDGETS[0]


def test_band_plan_lists_only_needed_rows():
    """At 2160p→224 the windows of neighbouring output rows do not touch:
    a band stages the rows they cover, not the span between them."""
    plan = fc.band_plan(2160, 3840, 224, 224, "lanczos", 1, 16, 16)
    ny = plan.band_rows[:, 0]
    assert (ny <= plan.rows * 6).all()
    assert ny.sum() < 0.7 * 2160


@pytest.mark.parametrize("shape,min_bands,rows", [
    ((464, 848, 61, 45), 13, 4),
    ((464, 848, 61, 45), 99, 1),
    ((1080, 1920, 224, 224), 7, 6),
    ((1080, 1920, 224, 224), 198, 1),
])
def test_band_plan_cuts_at_least_min_bands(shape, min_bands, rows):
    h, w, out_h, out_w = shape
    plan = fc.band_plan(h, w, out_h, out_w, "lanczos", 1, 16,
                        8 if (w // 2) % 16 else 16, min_bands)
    _check_plan(plan, h, w, out_h, out_w, "lanczos", 1)
    assert plan.rows == rows
    assert plan.n_bands >= min(min_bands, out_h)


@pytest.mark.parametrize("b,h,w,out_h,out_w,rows", [
    (32, 464, 848, 61, 45, 4),
    (4, 464, 848, 61, 45, 1),
    (32, 1080, 1920, 224, 224, 6),   # the main path: the grid is full
    (1, 1080, 1920, 224, 224, 1),
])
def test_wrapper_plan_fills_the_card(b, h, w, out_h, out_w, rows,
                                     monkeypatch):
    """The wrapper cuts shorter bands where the batch's grid would give
    each of an H100's 132 SMs fewer than MIN_BLOCKS_PER_SM blocks."""
    monkeypatch.setattr(fc, "_sm_count", lambda device: 132)
    y, u, v = (torch.from_numpy(p) for p in _yuv(b, h, w, seed=1))
    uv = torch.stack([u, v], -1).flatten(-2)
    for chroma in ((u, v), (uv,)):
        plan = fc.plan_for(y, *chroma, out_h=out_h, out_w=out_w)
        assert plan.rows == rows
        blocks = plan.n_bands * plan.n_tiles * b
        assert rows == 1 or blocks >= fc.MIN_BLOCKS_PER_SM * 132


def test_band_plan_fields_match_the_kernel():
    """PLAN_FIELDS is the order of the C entry point's PlanField enum,
    and the plan's ring depth and producer warps are the kernel's."""
    src = (pathlib.Path(fc.__file__).parent.parent / "csrc"
           / "fused_resize_csc.cu").read_text()
    body = re.search(r"enum PlanField \{(.*?)\};", src, re.S).group(1)
    names = [n.strip()[2:].lower() for n in body.split(",") if n.strip()]
    assert names == list(fc.PLAN_FIELDS) + ["count"]
    plan = fc.band_plan(1080, 1920, 224, 224)
    assert len(plan.fields()) == len(fc.PLAN_FIELDS)
    for name in ("STAGES", "PRODUCERS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert int(m.group(1)) == getattr(fc, name)


def test_band_plan_rejects_bad_step_and_stages():
    """The chroma step is 1 or 2; the ring depth is the kernel's, not the
    caller's."""
    with pytest.raises(ValueError):
        fc.band_plan(64, 96, 8, 8, "lanczos", 3)
    with pytest.raises(TypeError):
        fc.band_plan(64, 96, 8, 8, "lanczos", 1, stages=5)


def _packed_yuv420(b, h, w):
    """Planar YUV420 planes as views of one packed (B, H·3/2, W) buffer:
    the layout FusedPipeline unpacks (u, v rows of W/2 bytes)."""
    buf = torch.zeros((b, h * 3 // 2, w), dtype=torch.uint8)
    chroma = buf[:, h:, :]
    u = chroma[:, :h // 4, :].reshape(b, h // 2, w // 2)
    v = chroma[:, h // 4:, :].reshape(b, h // 2, w // 2)
    return buf[:, :h, :], u, v


@pytest.mark.parametrize(
    "h,w,want_y,want_c",
    [(464, 848, 16, 8),     # 424-byte chroma rows: 8-aligned only
     (1080, 1920, 16, 16),  # the main path
     (268, 482, 2, 1)],     # 482-byte luma rows, 241-byte chroma rows
)
def test_copy_width_divides_offsets_and_strides(h, w, want_y, want_c):
    y, u, v = _packed_yuv420(2, h, w)
    base = y.data_ptr()
    assert base % 16 == 0  # the allocator's alignment
    vec_y = fc.copy_width((y.data_ptr(),), y.stride()[:2], w)
    vec_c = fc.copy_width((u.data_ptr(), v.data_ptr()), u.stride()[:2],
                          w // 2)
    assert (vec_y, vec_c) == (want_y, want_c)
    for vec, vals in ((vec_y, (y.data_ptr() - base, *y.stride()[:2], w)),
                      (vec_c, (u.data_ptr() - base, v.data_ptr() - base,
                               *u.stride()[:2], w // 2))):
        assert all(x % vec == 0 for x in vals)
        if vec < 16:  # the widest: twice as wide does not divide
            assert any(x % (2 * vec) for x in vals)


def test_copy_width_of_an_offset_view():
    t = torch.zeros(64, dtype=torch.uint8)
    for off, want in ((0, 16), (8, 8), (4, 4), (2, 2), (1, 1)):
        assert fc.copy_width((t[off:].data_ptr(),), (32,), 32) == want


# ---- emulation of the band kernel ----------------------------------------------


def _emulate(plan, y, chroma, step, out_h, out_w, method, output, swap,
             mean, std, space=ColorSpace.BT_709, rng=ColorRange.MPEG):
    """numpy float32, block by block, reading only what the plan stages
    (bytes outside a staged span read as NaN)."""
    b, h, w = y.shape
    tabs = fc.tap_tables(h, w, out_h, out_w, method)
    (rsy, rwy), (rsc, rwc) = tabs["rows_y"], tabs["rows_c"]
    (csy, cwy), (csc, cwc) = tabs["cols_y"], tabs["cols_c"]
    planes = {"y": y}
    if step == 1:
        planes["u"], planes["v"] = chroma
    else:
        planes["uv"] = chroma[0]
    res = {k: np.full((b, out_h, out_w), np.nan, np.float32)
           for k in ("y", "u", "v")}

    def stage(plane, rows, lo, nbytes, pitch):
        buf = np.full((len(rows), pitch), np.nan, np.float32)
        buf[:, :nbytes] = plane[rows, lo:lo + nbytes]
        return buf

    def hpass(buf, starts, cw, first, st):
        idx = first[:, None] + st * np.arange(cw.shape[1])[None, :]
        assert idx.min() >= 0
        h = np.zeros((buf.shape[0], len(starts)), np.float32)
        for j in range(cw.shape[1]):  # j ascending, as the kernel
            h = h + cw[None, :, j] * buf[:, idx[:, j]]
        assert np.isfinite(h).all(), "read outside the staged span"
        return h

    def vpass(hbuf, wr, pos):
        acc = np.zeros(hbuf.shape[1], np.float32)
        for i, wt in enumerate(wr):
            if wt != 0:
                acc = acc + wt * hbuf[pos + i]
        return acc

    for f in range(b):
        for n in range(plan.n_bands):
            br = plan.band_rows[n]
            rows_y = br[2:2 + br[0]]
            off = 2 + plan.max_rows_y
            rows_c = br[off:off + br[1]]
            for t in range(plan.n_tiles):
                ox = np.arange(t * plan.cols, min(out_w, (t + 1) * plan.cols))
                lo_y, n_y, lo_c, n_c = plan.tile_cols[t]
                hy = hpass(stage(planes["y"][f], rows_y, lo_y, n_y,
                                 plan.pitch_y), ox, cwy[ox], csy[ox] - lo_y, 1)
                if step == 1:
                    hu, hv = (hpass(stage(planes[c][f], rows_c, lo_c, n_c,
                                          plan.pitch_c), ox, cwc[ox],
                                    csc[ox] - lo_c, 1) for c in "uv")
                else:
                    buf = stage(planes["uv"][f], rows_c, lo_c, n_c,
                                plan.pitch_c)
                    first = 2 * csc[ox] - lo_c
                    hu = hpass(buf, ox, cwc[ox], first, 2)
                    hv = hpass(buf, ox, cwc[ox], first + 1, 2)
                for oy in range(n * plan.rows,
                                min(out_h, (n + 1) * plan.rows)):
                    py, pc = plan.row_pos[:, oy]
                    res["y"][f, oy, ox] = vpass(hy, rwy[oy], py)
                    res["u"][f, oy, ox] = vpass(hu, rwc[oy], pc)
                    res["v"][f, oy, ox] = vpass(hv, rwc[oy], pc)
    m, offs, mean32, inv_std = fc._csc_consts(space, rng, swap, mean, std)
    yr, ur, vr = (torch.from_numpy(res[k]) - fc.f32(o)
                  for k, o in zip("yuv", offs))
    return torch.stack([
        fc._store(fc.f32(m[i, 0]) * yr + fc.f32(m[i, 1]) * ur
                  + fc.f32(m[i, 2]) * vr, output, mean32[i], inv_std[i])
        for i in range(3)], dim=1)


def _yuv(b, h, w, seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, 256, (b, h, w), np.uint8),
            r.integers(0, 256, (b, h // 2, w // 2), np.uint8),
            r.integers(0, 256, (b, h // 2, w // 2), np.uint8))


def _nv12(u, v):
    uv = np.empty(u.shape[:-1] + (2 * u.shape[-1],), np.uint8)
    uv[..., 0::2] = u
    uv[..., 1::2] = v
    return uv


EMULATED = [
    # (b, h, w, out_h, out_w, method, copy widths)
    (2, 48, 64, 24, 40, "lanczos", (16, 16)),
    (1, 96, 128, 40, 56, "bilinear", (16, 16)),
    (1, 96, 128, 40, 56, "nearest", (4, 2)),
    (1, 36, 52, 72, 300, "lanczos", (4, 2)),  # 3 tiles, upscale
    (1, 432, 768, 24, 24, "lanczos", (16, 16)),  # sparse rows
    (1, 62, 98, 17, 29, "lanczos", (2, 1)),  # a ragged last band
    (1, 16, 16384, 8, 24, "lanczos", (16, 16)),  # one row per chunk
    (1, 64, 96, 20, 113, "lanczos", (8, 4)),  # a ragged last tile
]


@pytest.mark.parametrize("layout", ["planar", "nv12"])
@pytest.mark.parametrize("case", EMULATED, ids=lambda c: f"{c[1]}x{c[2]}"
                         f"-{c[3]}x{c[4]}-{c[5]}")
def test_emulated_plan_matches_plain(case, layout):
    b, h, w, oh, ow, method, (vec_y, vec_c) = case
    step = 1 if layout == "planar" else 2
    plan = fc.band_plan(h, w, oh, ow, method, step, vec_y, vec_c)
    _check_plan(plan, h, w, oh, ow, method, step)
    y, u, v = _yuv(b, h, w, seed=h + ow)
    chroma = (u, v) if step == 1 else (_nv12(u, v),)
    t = torch.from_numpy
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for output in ("rgb_u8", "rgb_f32", "normalized"):
        kw = dict(out_h=oh, out_w=ow, method=method, output=output,
                  swap=output == "rgb_f32", mean=mean, std=std)
        got = _emulate(plan, y, chroma, step, oh, ow, method, output,
                       kw["swap"], mean, std)
        if step == 1:
            want = fc.fused_yuv420_resize_rgb_ref(t(y), t(u), t(v), **kw)
        else:
            want = fc.fused_nv12_resize_rgb_ref(t(y), t(chroma[0]), **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[output], (output, err)


@pytest.mark.parametrize("b,out", [(1, 224), (2, 224), (4, 224), (8, 224),
                                   (16, 224), (8, 512)])
def test_emulated_serving_plans_match_plain(b, out, monkeypatch):
    """The plans the wrapper takes on the serving path on an H100's 132
    SMs (packed 1080p YUV420: the image server's smaller buckets at 224²,
    whose grids cut shorter bands, and the FCN's 8 frames at 512², five
    tiles with a ragged last one), emulated on one frame against the
    plain version."""
    monkeypatch.setattr(fc, "_sm_count", lambda device: 132)
    h, w = 1080, 1920
    y, u, v = _packed_yuv420(b, h, w)
    plan = fc.plan_for(y, u, v, out_h=out, out_w=out)
    _check_plan(plan, h, w, out, out, "lanczos", 1)
    yn, un, vn = _yuv(1, h, w, seed=b + out)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = _emulate(plan, yn, (un, vn), 1, out, out, "lanczos", "normalized",
                   False, mean, std)
    want = fc.fused_yuv420_resize_rgb_ref(
        *(torch.from_numpy(p) for p in (yn, un, vn)), out_h=out, out_w=out,
        output="normalized", mean=mean, std=std)
    err = (got - want).abs().max().item()
    assert err <= TOL["normalized"], err


def test_emulated_plan_matches_pallas_interpret():
    """The plan's emulation against the JAX package's whole-frame Pallas
    kernel, interpret mode, at one of its own test shapes."""
    b, h, w, oh, ow = 1, 192, 384, 61, 45
    y, u, v = _yuv(b, h, w, seed=9)
    plan = fc.band_plan(h, w, oh, ow, "lanczos", 1, 16, 16)
    got = _emulate(plan, y, (u, v), 1, oh, ow, "lanczos", "rgb_u8", False,
                   (0.0,) * 3, (1.0,) * 3)
    want = np.asarray(fused_yuv420_resize_rgb_pallas(
        y, u, v, out_h=oh, out_w=ow, space=JColorSpace.BT_709,
        rng=JColorRange.MPEG, interpret=True))
    assert got.shape == want.shape
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


# ---- on the card -------------------------------------------------------------------


@pytest.mark.cuda
def test_band_kernel_equals_direct_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for b, h, w, oh, ow, method in [
        (4, 1080, 1920, 224, 224, "lanczos"),
        (2, 464, 848, 61, 45, "lanczos"),
        (1, 240, 320, 1080, 1920, "lanczos"),
        (2, 270, 482, 100, 300, "bilinear"),
        (2, 96, 128, 40, 56, "nearest"),
        (2, 62, 98, 17, 29, "lanczos"),  # a ragged last band
        (2, 16, 16384, 8, 24, "lanczos"),  # one row per chunk
        (2, 64, 96, 20, 113, "lanczos"),  # a ragged last tile
    ]:
        y, u, v = (torch.from_numpy(p).cuda() for p in _yuv(b, h, w, seed=3))
        uv = torch.stack([u, v], -1).flatten(-2)
        for chroma in ((u, v), (uv,)):
            kern = (fc.fused_yuv420_resize_rgb if len(chroma) == 2
                    else fc.fused_nv12_resize_rgb)
            for out in ("rgb_u8", "rgb_f32", "normalized"):
                kw = dict(out_h=oh, out_w=ow, method=method, output=out)
                got = kern(y, *chroma, **kw)
                want = fc._direct_resize_rgb(y, *chroma, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (h, w, oh, ow, len(chroma),
                                                out)


@pytest.mark.cuda
def test_refused_launch_raises_on_card(monkeypatch):
    """A plan asking for more shared memory than a block may have is
    refused by the card, and the wrapper raises: nothing falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    y, u, v = (torch.from_numpy(p).cuda() for p in _yuv(1, 64, 96, seed=1))
    plan = fc.band_plan(64, 96, 16, 24, "lanczos", 1, 16, 16)
    big = dataclasses.replace(plan, smem=fc.SMEM_MAX + 1024)
    monkeypatch.setattr(fc, "band_plan", lambda *a, **k: big)
    before = launch.LAUNCHES["fused_resize_csc"]
    with pytest.raises(RuntimeError, match="fused_resize_csc"):
        fc.fused_yuv420_resize_rgb(y, u, v, out_h=16, out_w=24)
    assert launch.LAUNCHES["fused_resize_csc"] == before
