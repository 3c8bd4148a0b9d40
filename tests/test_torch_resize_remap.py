"""The port's ``SurfaceResizer`` / ``resize_plane`` and ``SurfaceRemaper``
/ ``remap_image`` against the JAX package's ``ops/resize.py`` and
``ops/remap.py`` (mirrors the resize and remap cases of
tests/test_resize_remap.py).

Tolerances: u8 within 1 code (both sum the separable products in float32,
in another order); float32 within 1e-4.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.core.enums import PixelFormat as JF
from videoprocessingframework_tpu.core.surface import Surface as JSurface
from videoprocessingframework_tpu.ops import remap as jremap
from videoprocessingframework_tpu.ops import resize as jresize
from videoprocessingframework_torch.core import geometry
from videoprocessingframework_torch.core.enums import PixelFormat
from videoprocessingframework_torch.core.surface import Surface
from videoprocessingframework_torch.ops.remap import (
    SurfaceRemaper,
    remap_image,
)
from videoprocessingframework_torch.ops.resize import (
    SurfaceResizer,
    resize_plane,
)

F = PixelFormat
W, H, TW, TH = 64, 48, 32, 24
FAMILIES = [F.RGB, F.BGR, F.NV12, F.YUV420, F.YCBCR, F.YUV444, F.RGB_PLANAR,
            F.Y, F.RGB_32F, F.RGB_32F_PLANAR, F.P10]


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


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("method", ["lanczos", "bilinear", "nearest"])
@pytest.mark.parametrize("fmt", FAMILIES, ids=lambda f: f.name)
def test_surface_resizer_matches_jax(fmt, method):
    planes = _planes(fmt, seed=int(fmt))
    s = Surface(fmt, W, H, [p.copy() for p in planes]).to_device("cpu")
    out = SurfaceResizer(TW, TH, fmt, method).run(s)
    js = JSurface(JF(int(fmt)), W, H, planes)
    jout = jresize.SurfaceResizer(TW, TH, JF(int(fmt)), method).run(js)
    assert (out.width, out.height, out.format) == (TW, TH, fmt)
    assert out.is_on_device
    for p, jp, shp in zip(out.planes, jout.planes,
                          geometry.plane_shapes(fmt, TW, TH)):
        assert tuple(p.shape) == shp
        _close(p.numpy(), jp)


@pytest.mark.parametrize("method", ["lanczos", "bilinear", "nearest"])
def test_resize_identity(method):
    img = np.random.default_rng(1).integers(0, 256, (2, 32, 48), np.uint8)
    out = resize_plane(torch.from_numpy(img), h_out=32, w_out=48,
                       method=method)
    np.testing.assert_array_equal(out.numpy(), img)


def test_resize_plane_float_and_round_modes():
    r = np.random.default_rng(2)
    f32 = r.random((1, 16, 24, 3), np.float32)
    out = resize_plane(torch.from_numpy(f32), h_out=8, w_out=12)
    assert out.dtype == torch.float32
    _close(out.numpy(), jresize.resize_plane(f32, h_out=8, w_out=12))
    u8 = r.integers(0, 256, (2, 40, 56), np.uint8)
    raw = resize_plane(torch.from_numpy(u8), h_out=17, w_out=29,
                       round_u8=False)
    assert raw.dtype == torch.float32
    _close(raw.numpy(), jresize.resize_plane(u8, h_out=17, w_out=29,
                                             round_u8=False))
    const = np.full((1, 40, 56), 113, np.uint8)
    out = resize_plane(torch.from_numpy(const), h_out=17, w_out=29)
    assert int((out.int() - 113).abs().max()) <= 1


def test_resizer_checks_format():
    s = Surface(F.NV12, W, H, _planes(F.NV12)).to_device("cpu")
    with pytest.raises(ValueError, match="resizer format"):
        SurfaceResizer(TW, TH, F.YUV420).run(s)


def _maps(h_out, w_out, h, w, seed):
    r = np.random.default_rng(seed)
    # in-range, on-grid, half-pixel and out-of-range coordinates
    xs = r.uniform(-2.0, w + 1.0, (h_out, w_out)).astype(np.float32)
    ys = r.uniform(-2.0, h + 1.0, (h_out, w_out)).astype(np.float32)
    xs[0, :4] = [0.0, 0.5, w - 1, 2.5]
    ys[0, :4] = [0.0, 0.5, h - 1, 1.5]
    return xs, ys


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_remap_image_matches_jax(method, dtype):
    r = np.random.default_rng(3)
    h, w = 24, 32
    img = (r.integers(0, 256, (2, h, w, 3), np.uint8) if dtype == np.uint8
           else r.random((2, h, w, 3), np.float32))
    xs, ys = _maps(20, 28, h, w, seed=4)
    got = remap_image(torch.from_numpy(img), torch.from_numpy(xs),
                      torch.from_numpy(ys), method=method)
    want = jremap.remap_image(img, xs, ys, method=method)
    _close(got.numpy(), want)


def test_remap_identity_and_flip():
    h, w = 16, 20
    img = np.random.default_rng(5).integers(0, 256, (1, h, w, 3), np.uint8)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    t = torch.from_numpy(img)
    out = remap_image(t, torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_array_equal(out.numpy(), img)
    out = remap_image(t, torch.from_numpy(xs[:, ::-1].copy()),
                      torch.from_numpy(ys))
    np.testing.assert_array_equal(out.numpy(), img[:, :, ::-1, :])


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("fmt", [F.RGB, F.BGR], ids=lambda f: f.name)
def test_surface_remaper_matches_jax(fmt, method):
    h, w = 24, 32
    planes = _planes(fmt, w, h, seed=6)
    xs, ys = _maps(12, 16, h, w, seed=7)
    s = Surface(fmt, w, h, [planes[0].copy()]).to_device("cpu")
    out = SurfaceRemaper(xs, ys, fmt=fmt, method=method, device="cpu").run(s)
    jout = jremap.SurfaceRemaper(xs, ys, fmt=JF(int(fmt)),
                                 method=method).run(
        JSurface(JF(int(fmt)), w, h, planes))
    assert (out.width, out.height) == (16, 12)
    _close(out.planes[0].numpy(), jout.planes[0])


def test_surface_remaper_checks():
    xs = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="RGB/BGR"):
        SurfaceRemaper(xs, xs, fmt=F.NV12, device="cpu")
    with pytest.raises(ValueError, match="equally shaped"):
        SurfaceRemaper(xs, xs[:2], device="cpu")
    r = SurfaceRemaper(xs, xs, device="cpu")
    with pytest.raises(ValueError, match="remaper format"):
        r.run(Surface(F.BGR, 4, 4, _planes(F.BGR, 4, 4)))
