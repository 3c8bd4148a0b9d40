"""The port's fused post-processing against the JAX package.

* ``decode_postproc`` (torch path) vs the JAX ``decode_postproc`` for every
  source layout × output mode × compute mode. u8 outputs within 1 code;
  ``rgb_f32`` within atol 1e-4 and ``normalized`` within 5e-4 (dividing by
  std ≈ 0.225 scales the float32 error ×4.4).
* The kernel's plain versions vs the Pallas kernels in interpret mode
  (≤1 code) and vs the float64 golden (≤1 ULP), 1080p→224² included.
* ``FusedPipeline`` dispatch on the CPU.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.core.enums import (
    ColorRange as JColorRange,
    ColorSpace as JColorSpace,
    PixelFormat as JPixelFormat,
)
from videoprocessingframework_tpu.ops.fused import (
    decode_postproc as jax_decode_postproc,
)
from videoprocessingframework_tpu.ops.pallas_fused import (
    fused_nv12_resize_rgb_pallas,
    fused_yuv420_resize_rgb_pallas,
)
from videoprocessingframework_torch.core.enums import (
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.csrc import launch
from videoprocessingframework_torch.ops import colorspace as cspace
from videoprocessingframework_torch.ops import fused_cuda
from videoprocessingframework_torch.ops.fused import (
    FusedPipeline,
    decode_postproc,
)
from videoprocessingframework_torch.ops.resize import resize_matrix

U8_TOL = 1
F32_ATOL = {"rgb_f32": 1e-4, "normalized": 5e-4, "normalized_nchw": 5e-4}
OUTPUTS = ("rgb_u8", "rgb_f32", "normalized", "normalized_nchw")


def _planes(fmt, n=2, h=48, w=64, seed=0):
    """Seeded source planes of one layout, as numpy."""
    r = np.random.default_rng(seed)
    u8 = lambda *s: r.integers(0, 256, s, np.uint8)  # noqa: E731
    if fmt == "nv12":
        return PixelFormat.NV12, (u8(n, h, w), u8(n, h // 2, w))
    if fmt == "yuv420":
        return PixelFormat.YUV420, (
            u8(n, h, w), u8(n, h // 2, w // 2), u8(n, h // 2, w // 2))
    if fmt == "yuv420_packed":
        return PixelFormat.YUV420, (u8(n, h * 3 // 2, w),)
    if fmt == "yuv422":
        return PixelFormat.YUV422, (
            u8(n, h, w), u8(n, h, w // 2), u8(n, h, w // 2))
    if fmt == "yuv444":
        return PixelFormat.YUV444, (u8(n, h, w), u8(n, h, w), u8(n, h, w))
    if fmt == "y":
        return PixelFormat.Y, (u8(n, h, w),)
    if fmt == "p10":
        p16 = lambda *s: (r.integers(0, 1024, s) << 6).astype(np.uint16)  # noqa
        return PixelFormat.P10, (p16(n, h, w), p16(n, h // 2, w))
    raise ValueError(fmt)


def _compare(got, want, output):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if output == "rgb_u8":
        assert np.abs(got.astype(int) - want.astype(int)).max() <= U8_TOL
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL[output])


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("compute", ["highest", "split_bf16"])
@pytest.mark.parametrize(
    "fmt", ["nv12", "yuv420", "yuv420_packed", "yuv422", "yuv444", "y", "p10"]
)
def test_decode_postproc_matches_jax(fmt, compute, output):
    pf, planes = _planes(fmt)
    kw = dict(space=ColorSpace.BT_709, rng=ColorRange.MPEG, out_h=24,
              out_w=40, output=output, compute=compute, swap=(fmt == "y"))
    want = jax_decode_postproc(
        *planes, src_format=JPixelFormat(int(pf)),
        **dict(kw, space=JColorSpace.BT_709, rng=JColorRange.MPEG),
    )
    got = decode_postproc(*map(torch.from_numpy, planes), src_format=pf,
                          **kw)
    _compare(got.numpy(), want, output)


@pytest.mark.parametrize(
    "case",
    [
        # (out_h, out_w, method, src_window): upscale, nearest, bilinear,
        # an ROI window, and a no-resize identity shape
        (96, 128, "lanczos", None),
        (24, 40, "nearest", None),
        (24, 40, "bilinear", None),
        (24, 40, "lanczos", (4, 8, 32, 40)),
        (48, 64, "lanczos", None),
    ],
)
def test_decode_postproc_methods_and_window_match_jax(case):
    out_h, out_w, method, win = case
    pf, planes = _planes("nv12", seed=5)
    kw = dict(out_h=out_h, out_w=out_w, method=method, src_window=win,
              compute="highest")
    want = jax_decode_postproc(
        *planes, src_format=JPixelFormat.NV12, space=JColorSpace.BT_601,
        rng=JColorRange.JPEG, **kw,
    )
    got = decode_postproc(*map(torch.from_numpy, planes), src_format=pf,
                          space=ColorSpace.BT_601, rng=ColorRange.JPEG, **kw)
    _compare(got.numpy(), want, "rgb_u8")


def _golden(y, u, v, out_h, out_w, method="lanczos",
            space=ColorSpace.BT_709, rng=ColorRange.MPEG):
    """float64 golden: dense resize of Y and of replicate-upsampled chroma,
    float64 CSC, round half to even — (B, H', W', 3)."""
    h, w = y.shape[-2:]
    rm = resize_matrix(h, out_h, method).astype(np.float64)
    cm = resize_matrix(w, out_w, method).astype(np.float64)

    def rsz(p):
        return np.einsum("oh,nhw->now", rm, p.astype(np.float64)) @ cm.T

    up = lambda c: np.repeat(np.repeat(c, 2, 1), 2, 2)  # noqa: E731
    m, off = cspace.rgb_from_ycbcr_matrix(space, rng)
    ycc = np.stack([rsz(y) - off[0], rsz(up(u)) - off[1],
                    rsz(up(v)) - off[2]], -1)
    return np.clip(np.rint(np.einsum("...c,dc->...d", ycc, m)), 0, 255)


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


# shapes of the JAX package's Pallas tests (interpret mode)
PALLAS_SHAPES = [(2, 256, 512, 64, 48), (1, 192, 384, 61, 45),
                 (2, 96, 512, 32, 48)]


@pytest.mark.parametrize(
    "shape,layout",
    # the NV12 Pallas kernel needs out_h % 8 == 0
    [(s, "planar") for s in PALLAS_SHAPES]
    + [(s, "nv12") for s in PALLAS_SHAPES if s[3] % 8 == 0],
)
def test_plain_kernel_matches_pallas_interpret(shape, layout):
    b, h, w, oh, ow = shape
    y, u, v = _yuv(b, h, w, seed=h + ow)
    kw = dict(out_h=oh, out_w=ow, space=JColorSpace.BT_709,
              rng=JColorRange.MPEG)
    tkw = dict(kw, space=ColorSpace.BT_709, rng=ColorRange.MPEG)
    t = torch.from_numpy
    if layout == "planar":
        want = fused_yuv420_resize_rgb_pallas(y, u, v, interpret=True, **kw)
        got = fused_cuda.fused_yuv420_resize_rgb(t(y), t(u), t(v), **tkw)
    else:
        uv = _nv12(u, v)
        want = fused_nv12_resize_rgb_pallas(y, uv, interpret=True, **kw)
        got = fused_cuda.fused_nv12_resize_rgb(t(y), t(uv), **tkw)
    want = np.asarray(want)
    assert got.shape == want.shape == (b, 3, oh, ow)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        got.numpy(),
        fused_cuda.fused_yuv420_resize_rgb_ref(t(y), t(u), t(v), **tkw)
        .numpy(),
    )


@pytest.mark.parametrize("layout", ["planar", "nv12"])
@pytest.mark.parametrize(
    "shape",
    [(1, 1080, 1920, 224, 224), (2, 256, 512, 64, 48), (1, 464, 848, 61, 45),
     (1, 360, 480, 480, 640)],
)
def test_plain_kernel_one_ulp_vs_golden(shape, layout):
    b, h, w, oh, ow = shape
    y, u, v = _yuv(b, h, w, seed=oh)
    t = torch.from_numpy
    kw = dict(out_h=oh, out_w=ow)
    if layout == "planar":
        got = fused_cuda.fused_yuv420_resize_rgb(t(y), t(u), t(v), **kw)
    else:
        got = fused_cuda.fused_nv12_resize_rgb(t(y), t(_nv12(u, v)), **kw)
    want = _golden(y, u, v, oh, ow)
    got = np.moveaxis(got.numpy(), 1, -1)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("compute", ["split_bf16", "highest", "auto"])
def test_decode_postproc_one_ulp_vs_golden(compute):
    """Every compute mode of the torch path meets the ≤1 u8 ULP bar
    against the float64 golden, split_bf16's hi/lo decomposition
    included."""
    y, u, v = _yuv(2, 256, 512, seed=21)
    got = decode_postproc(
        *map(torch.from_numpy, (y, u, v)), src_format=PixelFormat.YUV420,
        space=ColorSpace.BT_709, rng=ColorRange.MPEG, out_h=64, out_w=48,
        compute=compute,
    )
    want = _golden(y, u, v, 64, 48)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_plain_kernel_methods_vs_golden(method):
    y, u, v = _yuv(1, 128, 192, seed=7)
    t = torch.from_numpy
    got = fused_cuda.fused_yuv420_resize_rgb(
        t(y), t(u), t(v), out_h=40, out_w=56, method=method,
        space=ColorSpace.BT_601, rng=ColorRange.JPEG,
    )
    want = _golden(y, u, v, 40, 56, method, ColorSpace.BT_601,
                   ColorRange.JPEG)
    got = np.moveaxis(got.numpy(), 1, -1)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_plain_kernel_output_modes_and_swap():
    """rgb_f32 / normalized share the u8 path's float pipeline and the
    mean/std apply per OUTPUT channel after the swap (the Pallas
    convention)."""
    y, u, v = _yuv(1, 96, 512, seed=3)
    t = torch.from_numpy
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    kw = dict(out_h=32, out_w=48, swap=True)
    f = fused_cuda.fused_yuv420_resize_rgb
    u8 = f(t(y), t(u), t(v), **kw).numpy()
    f32 = f(t(y), t(u), t(v), output="rgb_f32", **kw).numpy()
    norm = f(t(y), t(u), t(v), output="normalized", mean=mean, std=std,
             **kw).numpy()
    want = (f32 - np.asarray(mean)[:, None, None]) \
        / np.asarray(std)[:, None, None]
    np.testing.assert_allclose(norm, want.astype(np.float32), atol=1e-5)
    assert np.abs(np.rint(f32 * 255.0).astype(int) - u8.astype(int)).max() \
        <= 1
    pallas = np.asarray(fused_yuv420_resize_rgb_pallas(
        y, u, v, out_h=32, out_w=48, swap=True, output="normalized",
        mean=mean, std=std, interpret=True,
    ))
    np.testing.assert_allclose(norm, pallas, rtol=0, atol=5e-4)


@pytest.mark.parametrize("channels_first", [False, True])
def test_normalize_matches_jax(channels_first):
    from videoprocessingframework_tpu.ops.normalize import (
        normalize as jax_normalize,
    )
    from videoprocessingframework_torch.ops.normalize import normalize

    img = np.random.default_rng(2).integers(0, 256, (2, 8, 12, 3), np.uint8)
    want = np.asarray(jax_normalize(img, channels_first=channels_first))
    got = normalize(torch.from_numpy(img), channels_first=channels_first)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_fused_pipeline_cpu_picks_torch_path():
    pf, (y, u, v) = _planes("yuv420", n=2, h=64, w=96)
    launch.reset_launches()
    pipe = FusedPipeline(pf, ColorSpace.BT_709, ColorRange.MPEG, (40, 24),
                         output="normalized", device="cpu")
    out = pipe(y, u, v)
    assert out.device.type == "cpu" and out.shape == (2, 24, 40, 3)
    assert launch.LAUNCHES["fused_resize_csc"] == 0
    want = decode_postproc(
        *map(torch.from_numpy, (y, u, v)), src_format=pf,
        space=ColorSpace.BT_709, rng=ColorRange.MPEG, out_h=24, out_w=40,
        output="normalized",
    )
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    nchw = FusedPipeline(pf, ColorSpace.BT_709, ColorRange.MPEG, (40, 24),
                         output="normalized_nchw", device="cpu")(y, u, v)
    torch.testing.assert_close(nchw, out.permute(0, 3, 1, 2))


def test_fused_pipeline_refuses_cuda_on_cpu(monkeypatch):
    with pytest.raises(ValueError):
        FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                      ColorRange.MPEG, (40, 24), device="cpu",
                      kernel="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                      ColorRange.MPEG, (40, 24))


def test_kernel_wrappers_reject_bad_planes():
    y, u, v = (torch.from_numpy(p) for p in _yuv(1, 64, 96, seed=1))
    with pytest.raises(ValueError):
        fused_cuda.fused_yuv420_resize_rgb(y.float(), u, v, out_h=8, out_w=8)
    with pytest.raises(ValueError):
        fused_cuda.fused_yuv420_resize_rgb(y, u[:, :-1], v, out_h=8, out_w=8)
    with pytest.raises(ValueError):
        fused_cuda.fused_yuv420_resize_rgb(y, u, v, out_h=8, out_w=8,
                                           output="normalized_nchw")
    assert not fused_cuda.fused_cuda_supported(63, 96, 8, 8)
    assert not fused_cuda.fused_cuda_supported(64, 96, 8, 8, "bicubic")
    assert fused_cuda.fused_cuda_supported(1080, 1920, 224, 224)
    assert fused_cuda.fused_cuda_supported(2160, 3840, 224, 224)
    assert fused_cuda.fused_cuda_supported(464, 848, 61, 45)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for b, h, w, oh, ow in [(4, 1080, 1920, 224, 224), (1, 464, 848, 61, 45)]:
        y, u, v = (torch.from_numpy(p).cuda() for p in _yuv(b, h, w, seed=2))
        for out in ("rgb_u8", "rgb_f32", "normalized"):
            kw = dict(out_h=oh, out_w=ow, output=out)
            got = fused_cuda.fused_yuv420_resize_rgb(y, u, v, **kw)
            want = fused_cuda.fused_yuv420_resize_rgb_ref(y, u, v, **kw)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= (1 if out == "rgb_u8" else 5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["yuv420", "yuv420_packed", "nv12",
                                 "nv12_packed"])
def test_fused_pipeline_cuda_layouts_on_card(fmt):
    """FusedPipeline(kernel="cuda") takes every 4:2:0 layout the torch
    path takes and agrees with it; the kernel launches once per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    y, u, v = _yuv(2, 464, 848, seed=4)
    uv = _nv12(u, v)
    planes = {
        "yuv420": (y, u, v),
        "yuv420_packed": (np.concatenate(
            [y, u.reshape(2, 116, 848), v.reshape(2, 116, 848)], 1),),
        "nv12": (y, uv),
        "nv12_packed": (np.concatenate([y, uv], 1),),
    }[fmt]
    pf = PixelFormat.NV12 if fmt.startswith("nv12") else PixelFormat.YUV420
    for output in OUTPUTS:
        kw = dict(output=output, device="cuda")
        cuda = FusedPipeline(pf, ColorSpace.BT_709, ColorRange.MPEG,
                             (45, 61), kernel="cuda", **kw)
        ref = FusedPipeline(pf, ColorSpace.BT_709, ColorRange.MPEG,
                            (45, 61), kernel="torch", **kw)
        before = launch.LAUNCHES["fused_resize_csc"]
        got = cuda(*planes)
        assert launch.LAUNCHES["fused_resize_csc"] == before + 1
        want = ref(*planes)
        assert got.shape == want.shape and got.dtype == want.dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= (1 if output == "rgb_u8" else 5e-4), (output, err)
