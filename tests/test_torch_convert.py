"""The port's ``SurfaceConverter`` against the JAX package's and the
float64 golden: every registered pair × every supported (space, range)
combination, the same errors, and the ``fidelity="npp-fixed"`` integer
mode (mirrors tests/test_convert.py and tests/test_npp_fixed.py).

Tolerances: ≤1 code for u8 pairs computed in float32 (the JAX package
sums the 3×3 product in an XLA dot, the port as ``(m0·y + m1·u) + m2·v``
with each op rounded, so a code may flip at a rounding boundary);
exact for layout-only pairs, the P10/P12 → NV12 rescale (a power-of-two
scale) and the npp-fixed integer mode; ≤1e-7 for RGB → RGB_32F.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.core.enums import PixelFormat as JF
from videoprocessingframework_tpu.core.packet import (
    ColorspaceConversionContext as JCtx,
)
from videoprocessingframework_tpu.core.surface import Surface as JSurface
from videoprocessingframework_tpu.ops import convert as jconvert
from videoprocessingframework_torch.core import geometry
from videoprocessingframework_torch.core.enums import (
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.core.exceptions import (
    UnsupportedConversion,
)
from videoprocessingframework_torch.core.packet import (
    ColorspaceConversionContext,
)
from videoprocessingframework_torch.core.surface import Surface
from videoprocessingframework_torch.csrc import launch
from videoprocessingframework_torch.ops import colorspace as cs
from videoprocessingframework_torch.ops import convert, golden
from videoprocessingframework_torch.ops.convert import (
    FIXED_ROUNDINGS,
    SurfaceConverter,
)

F = PixelFormat
CS, CR = ColorSpace, ColorRange
W, H = 64, 48

#: pairs whose output is a re-layout or exact rescale of the input
EXACT = {(F.NV12, F.YUV420), (F.YUV420, F.NV12), (F.P10, F.NV12),
         (F.P12, F.NV12), (F.RGB, F.RGB_PLANAR), (F.RGB_PLANAR, F.RGB),
         (F.Y, F.YUV444), (F.RGB, F.BGR), (F.BGR, F.RGB), (F.NV12, F.Y),
         (F.RGB_32F, F.RGB_32F_PLANAR)}


def _cases():
    """(src, dst, combo or None) for every registered pair: each supported
    combination of the pairs that take a conversion context."""
    out = []
    for (src, dst), impl in sorted(SurfaceConverter.PAIRS.items()):
        if impl["ctx"] is None:
            out.append((src, dst, None))
            continue
        table = (cs.TO_RGB_COMBOS if impl["ctx"] == "to_rgb"
                 else cs.FROM_RGB_COMBOS)
        out += [(src, dst, c) for c in sorted(table[impl["combos"]])]
    return out


CASES = _cases()


def _planes(fmt, w=W, h=H, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for i, shp in enumerate(geometry.plane_shapes(fmt, w, h)):
        dt = geometry.plane_dtype(fmt, i)
        if dt == np.float32:
            out.append(r.random(shp, np.float32))
        elif dt == np.uint16:
            out.append(r.integers(0, 65536, shp, np.uint16))
        else:
            out.append(r.integers(0, 256, shp, np.uint8))
    return out


def _port_surface(fmt, planes, w=W, h=H):
    return Surface(fmt, w, h, [p.copy() for p in planes]).to_device("cpu")


def _jax_run(src, dst, planes, combo, w=W, h=H, **kw):
    s = JSurface(JF(int(src)), w, h, [p.copy() for p in planes])
    cc = None if combo is None else JCtx(*combo)
    conv = jconvert.SurfaceConverter(w, h, JF(int(src)), JF(int(dst)), **kw)
    return [np.asarray(p) for p in conv.run(s, cc).planes]


def _port_run(src, dst, planes, combo, w=W, h=H, **kw):
    cc = None if combo is None else ColorspaceConversionContext(*combo)
    out = SurfaceConverter(w, h, src, dst, **kw).run(
        _port_surface(src, planes, w, h), cc)
    assert out.format == dst and out.is_on_device
    return [p.numpy() for p in out.planes]


def _golden(src, dst, planes, combo):
    """Expected output planes from the float64 golden (None for pairs
    without a colour computation)."""
    space, rng = combo if combo else (None, None)

    def hw3(p):
        return p.reshape(H, W, 3)

    if src == F.NV12 and dst in (F.RGB, F.BGR, F.RGB_PLANAR):
        rgb = golden.nv12_to_rgb(*planes, space, rng)
    elif src in (F.YUV420, F.YCBCR) and dst in (F.RGB, F.BGR, F.RGB_PLANAR):
        rgb = golden.yuv420_to_rgb(*planes, space, rng)
    elif src == F.YUV444 and dst in (F.RGB, F.BGR, F.RGB_PLANAR):
        rgb = golden.ycbcr_to_rgb(*planes, space, rng)
    elif dst in (F.YUV420, F.YCBCR) and src in (F.RGB, F.BGR):
        img = hw3(planes[0])
        return list(golden.rgb_to_yuv420(
            img[..., ::-1] if src == F.BGR else img, space, rng))
    elif dst == F.YUV444 and src in (F.RGB, F.BGR, F.RGB_PLANAR):
        img = (np.moveaxis(planes[0].reshape(3, H, W), 0, -1)
               if src == F.RGB_PLANAR else hw3(planes[0]))
        return list(golden.rgb_to_yuv444(
            img[..., ::-1] if src == F.BGR else img, space, rng))
    elif (src, dst) == (F.RGB, F.Y):
        return [golden.rgb_to_gray(hw3(planes[0]))]
    elif (src, dst) == (F.RGB, F.RGB_32F):
        return [golden.rgb8_to_rgb32f(planes[0])]
    elif dst == F.NV12 and src in (F.P10, F.P12):
        return [golden.p16_to_8bit(p) for p in planes]
    else:
        return None
    if dst == F.BGR:
        rgb = rgb[..., ::-1]
    if dst == F.RGB_PLANAR:
        return [np.moveaxis(rgb, -1, 0).reshape(3 * H, W)]
    return [rgb.reshape(H, 3 * W)]


def _compare(got, want, src, dst):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
        elif (src, dst) in EXACT:
            np.testing.assert_array_equal(g, w)
        else:
            d = np.abs(g.astype(int) - w.astype(int))
            assert d.max() <= 1, (
                f"max diff {d.max()} ({int((d > 0).sum())} codes off)")


@pytest.mark.parametrize(
    "src,dst,combo", CASES,
    ids=[f"{s.name}-{d.name}-" + (f"{c[0].name}-{c[1].name}" if c else "")
         for s, d, c in CASES])
def test_pair_matches_jax_and_golden(src, dst, combo):
    planes = _planes(src, seed=int(src) * 31 + int(dst))
    got = _port_run(src, dst, planes, combo)
    _compare(got, _jax_run(src, dst, planes, combo), src, dst)
    want = _golden(src, dst, planes, combo)
    if want is not None:
        _compare(got, want, src, None)  # ≤1 code vs the golden


def test_every_jax_pair_is_ported():
    jpairs = {(int(a), int(b)): v for (a, b), v in
              jconvert.SurfaceConverter.PAIRS.items()}
    ppairs = {(int(a), int(b)): v for (a, b), v in
              SurfaceConverter.PAIRS.items()}
    assert jpairs.keys() == ppairs.keys()
    for k, v in jpairs.items():
        assert (v["ctx"], v["combos"], v["fixed_ok"], v["name"]) == (
            ppairs[k]["ctx"], ppairs[k]["combos"], ppairs[k]["fixed_ok"],
            ppairs[k]["name"])


@pytest.mark.parametrize("h,w", [(30, 100), (270, 482)])
@pytest.mark.parametrize("src", [F.NV12, F.YUV420])
def test_rgb_planar_pairs_untiled_size(src, h, w):
    """Both RGB_PLANAR pairs at sizes the TPU kernel refuses (H%32,
    W%128): the port takes them (through the kernel's plain version on
    the CPU) and matches the JAX package and the golden."""
    combo = (CS.BT_601, CR.JPEG)
    planes = _planes(src, w, h, seed=h)
    launch.reset_launches()
    got = _port_run(src, F.RGB_PLANAR, planes, combo, w, h)
    assert launch.LAUNCHES["csc_rgb_planar"] == 0  # CPU: plain version
    want = _jax_run(src, F.RGB_PLANAR, planes, combo, w, h)
    assert got[0].shape == (3 * h, w)
    assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1
    gold = (golden.nv12_to_rgb(*planes, *combo) if src == F.NV12
            else golden.yuv420_to_rgb(*planes, *combo))
    gold = np.moveaxis(gold, -1, 0).reshape(3 * h, w)
    assert np.abs(got[0].astype(int) - gold.astype(int)).max() <= 1


@pytest.mark.parametrize("src,dst,combo", [
    (F.NV12, F.RGB, None),  # default (BT_601, MPEG) is unsupported
    (F.NV12, F.RGB_PLANAR, None),
    (F.YUV420, F.RGB, (CS.BT_709, CR.JPEG)),
    (F.YUV420, F.RGB_PLANAR, (CS.BT_709, CR.MPEG)),
    (F.YUV444, F.RGB, (CS.BT_601, CR.MPEG)),
    (F.BGR, F.YUV444, (CS.BT_709, CR.JPEG)),
    (F.BGR, F.YCBCR, (CS.BT_601, CR.JPEG)),
])
def test_unsupported_combination_errors(src, dst, combo):
    planes = _planes(src)
    with pytest.raises(Exception) as jerr:
        _jax_run(src, dst, planes, combo)
    with pytest.raises(UnsupportedConversion) as perr:
        _port_run(src, dst, planes, combo)
    assert str(perr.value) == str(jerr.value)


def test_unsupported_pair_message():
    with pytest.raises(UnsupportedConversion, match="Unsupported pixel format"):
        SurfaceConverter(W, H, F.YUV422, F.RGB)


def test_run_checks_surface():
    conv = SurfaceConverter(W, H, F.NV12, F.YUV420)
    with pytest.raises(ValueError, match="converter is"):
        conv.run(_port_surface(F.NV12, _planes(F.NV12, 32, 16), 32, 16))
    with pytest.raises(ValueError, match="converter input"):
        conv.run(_port_surface(F.YUV420, _planes(F.YUV420)))


def test_roundtrips_lossless():
    nv12 = _port_surface(F.NV12, _planes(F.NV12, seed=3))
    back = SurfaceConverter(W, H, F.YUV420, F.NV12).run(
        SurfaceConverter(W, H, F.NV12, F.YUV420).run(nv12))
    for a, b in zip(back.planes, nv12.planes):
        assert torch.equal(a, b)
    rgb = _port_surface(F.RGB, _planes(F.RGB, seed=4))
    pl = SurfaceConverter(W, H, F.RGB, F.RGB_PLANAR).run(rgb)
    assert pl.planes[0].shape == (3 * H, W)
    assert torch.equal(
        SurfaceConverter(W, H, F.RGB_PLANAR, F.RGB).run(pl).planes[0],
        rgb.planes[0])
    bgr = SurfaceConverter(W, H, F.RGB, F.BGR).run(rgb)
    assert torch.equal(
        SurfaceConverter(W, H, F.BGR, F.RGB).run(bgr).planes[0],
        rgb.planes[0])


def test_outputs_do_not_alias_inputs():
    """Layout-only pairs hand back new tensors: writing into the result
    leaves the source alone (JAX arrays are immutable; torch's are not)."""
    nv12 = _port_surface(F.NV12, _planes(F.NV12, seed=5))
    y0 = nv12.planes[0].clone()
    for dst in (F.Y, F.YUV420):
        out = SurfaceConverter(W, H, F.NV12, dst).run(nv12)
        for p in out.planes:
            assert p.is_contiguous()
            p.fill_(7)
    assert torch.equal(nv12.planes[0], y0)
    y = _port_surface(F.Y, _planes(F.Y, seed=6))
    out = SurfaceConverter(W, H, F.Y, F.YUV444).run(y)
    out.planes[1].fill_(0)
    assert int(out.planes[2].min()) == 128  # u and v are separate tensors


def test_rgb_to_yuv420_default_is_jpeg():
    rgb = _port_surface(F.RGB, _planes(F.RGB, seed=7))
    conv = SurfaceConverter(W, H, F.RGB, F.YUV420)
    a = conv.run(rgb)
    b = conv.run(rgb, ColorspaceConversionContext(CS.BT_601, CR.JPEG))
    for p, q in zip(a.planes, b.planes):
        assert torch.equal(p, q)


def test_batched_matches_single():
    r = np.random.default_rng(8)
    ys = torch.from_numpy(r.integers(0, 256, (4, H, W), np.uint8))
    uvs = torch.from_numpy(r.integers(0, 256, (4, H // 2, W), np.uint8))
    out = convert.nv12_to_rgb(ys, uvs, space=CS.BT_709, rng=CR.MPEG)
    for i in range(4):
        want = golden.nv12_to_rgb(ys[i].numpy(), uvs[i].numpy(), CS.BT_709,
                                  CR.MPEG)
        assert np.abs(out[i].numpy().astype(int) - want).max() <= 1
        assert torch.equal(out[i], convert.nv12_to_rgb(
            ys[i:i + 1], uvs[i:i + 1], space=CS.BT_709, rng=CR.MPEG)[0])


def test_host_surface_needs_a_device(monkeypatch):
    """A host (numpy) Surface is uploaded to the default device, CUDA;
    without a GPU that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = Surface(F.NV12, W, H, _planes(F.NV12))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SurfaceConverter(W, H, F.NV12, F.Y).run(s)


# ---- fidelity="npp-fixed" ---------------------------------------------------

FIXED_PAIRS = [k for k, v in sorted(SurfaceConverter.PAIRS.items())
               if v["fixed_ok"]]


def _fixed_rgb_np(y, cb, cr, space, rng, q, rounding):
    """Exact integer mirror of ops.convert._apply_to_rgb_fixed."""
    mq, offi = convert.quantize_csc_matrix(space, rng, q)
    ycc = np.stack([y, cb, cr], -1).astype(np.int64) - offi
    acc = ycc @ mq.astype(np.int64).T
    if rounding == "half_up":
        out = (acc + (1 << (q - 1))) >> q
    elif rounding == "half_even":
        out = (acc + (1 << (q - 1)) - 1 + ((acc >> q) & 1)) >> q
    else:
        out = acc >> q
    return np.clip(out, 0, 255)


@pytest.mark.parametrize("q", [8, 10, 16])
@pytest.mark.parametrize("rounding", FIXED_ROUNDINGS)
@pytest.mark.parametrize("src,dst", FIXED_PAIRS,
                         ids=[f"{s.name}-{d.name}" for s, d in FIXED_PAIRS])
def test_npp_fixed_bit_exact_vs_jax(src, dst, rounding, q):
    impl = SurfaceConverter.PAIRS[(src, dst)]
    combo = sorted(cs.TO_RGB_COMBOS[impl["combos"]])[0]
    planes = _planes(src, seed=q)
    kw = dict(fidelity="npp-fixed", fixed_q=q, fixed_rounding=rounding)
    got = _port_run(src, dst, planes, combo, **kw)
    want = _jax_run(src, dst, planes, combo, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rounding", FIXED_ROUNDINGS)
def test_npp_fixed_matches_integer_mirror(rounding):
    r = np.random.default_rng(3)
    yp, up, vp = (r.integers(0, 256, (1, 32, 64), np.uint8) for _ in range(3))
    got = convert.yuv444_to_rgb(
        *(torch.from_numpy(p) for p in (yp, up, vp)),
        space=CS.BT_709, rng=CR.MPEG, fixed=(10, rounding)).numpy()
    want = _fixed_rgb_np(yp, up, vp, CS.BT_709, CR.MPEG, 10, rounding)
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_npp_fixed_within_one_code_of_exact():
    cc = ColorspaceConversionContext(CS.BT_709, CR.MPEG)
    s = _port_surface(F.NV12, _planes(F.NV12, 32, 16, seed=11), 32, 16)
    fixed = SurfaceConverter(32, 16, F.NV12, F.RGB, fidelity="npp-fixed",
                             fixed_q=10).run(s, cc).planes[0]
    exact = SurfaceConverter(32, 16, F.NV12, F.RGB).run(s, cc).planes[0]
    assert fixed.shape == exact.shape
    assert int((fixed.int() - exact.int()).abs().max()) <= 1


def test_fidelity_mode_errors():
    with pytest.raises(ValueError, match="fidelity"):
        SurfaceConverter(32, 16, F.NV12, F.RGB, fidelity="wat")
    with pytest.raises(UnsupportedConversion, match="npp-fixed"):
        SurfaceConverter(32, 16, F.NV12, F.YUV420, fidelity="npp-fixed")
    with pytest.raises(UnsupportedConversion, match="npp-fixed"):
        SurfaceConverter(32, 16, F.NV12, F.RGB_PLANAR, fidelity="npp-fixed")
    with pytest.raises(ValueError, match="int32-safe"):
        SurfaceConverter(32, 16, F.NV12, F.RGB, fidelity="npp-fixed",
                         fixed_q=24)
    with pytest.raises(ValueError, match="rounding"):
        SurfaceConverter(32, 16, F.NV12, F.RGB, fidelity="npp-fixed",
                         fixed_rounding="stochastic")
