"""The port's outbound feed against the JAX package and the float64
golden (mirrors tests/test_encode_feed.py).

* ``encode_feed`` / ``encode_feed_gray`` vs the JAX functions at
  ``compute="highest"`` (both full float32): within 1 code; the port's
  ``split_bf16`` vs the JAX ``split_bf16``: within 1 code.
* Both vs the float64 golden (resize matrices + golden.rgb_to_yuv420):
  within 1 code.
* ``planes_to_host_packed``: bit-equal to the JAX function; the packed
  frames are a valid YUV420 input of the port's ``VideoEncoder``.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.core.enums import (
    ColorRange as JColorRange,
    ColorSpace as JColorSpace,
)
from videoprocessingframework_tpu.ops import fused as jfused
from videoprocessingframework_torch.core.enums import ColorRange, ColorSpace
from videoprocessingframework_torch.ops import colorspace as cs
from videoprocessingframework_torch.ops import golden
from videoprocessingframework_torch.ops.fused import (
    encode_feed,
    encode_feed_gray,
    planes_to_host_packed,
)
from videoprocessingframework_torch.ops.resize import resize_matrix

CPU = {"device": "cpu"}
TOL = 1  # u8 codes, against the JAX functions and the golden
COLORIMETRY = [(ColorSpace.BT_709, ColorRange.MPEG),
               (ColorSpace.BT_601, ColorRange.JPEG)]


def _rgb(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _np(planes):
    return tuple(np.asarray(p) for p in planes)


def _maxdiff(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _golden_resized(rgb, oh, ow):
    n, h, w, _ = rgb.shape
    rm = resize_matrix(h, oh, "lanczos").astype(np.float64)
    cm = resize_matrix(w, ow, "lanczos").astype(np.float64)
    out = np.einsum("oh,nhwc->nowc", rm, rgb.astype(np.float64))
    return np.einsum("pw,nhwc->nhpc", cm, out)


def _golden_feed(rgb, oh, ow, space, rng):
    """float64: resize each channel by the exact matrices, then
    golden.rgb_to_ycbcr's matrix, 2×2 chroma mean, round."""
    out = _golden_resized(rgb, oh, ow)
    m, off = cs.ycbcr_from_rgb_matrix(space, rng)
    ycc = out @ m.T + off
    y = golden._round_u8(ycc[..., 0])
    u = golden._round_u8(golden.downsample_chroma_420(ycc[..., 1]))
    v = golden._round_u8(golden.downsample_chroma_420(ycc[..., 2]))
    return y, u, v


def _jax(fn, rgb, space, rng, **kw):
    """The JAX function's planes as numpy (one array for the gray feed)."""
    out = getattr(jfused, fn)(
        rgb, space=JColorSpace(int(space)), rng=JColorRange(int(rng)), **kw)
    return _np(out) if isinstance(out, tuple) else np.asarray(out)


@pytest.mark.parametrize("space,rng", COLORIMETRY)
def test_no_resize_matches_golden_and_jax(space, rng):
    rgb = _rgb((2, 64, 96, 3), 21)
    got = _np(encode_feed(rgb, out_h=64, out_w=96, space=space, rng=rng,
                          **CPU))
    want = golden.rgb_to_yuv420(rgb, space, rng)
    jax_ = _jax("encode_feed", rgb, space, rng, out_h=64, out_w=96,
                compute="highest")
    for g, w, j in zip(got, want, jax_):
        assert g.shape == w.shape == j.shape
        assert _maxdiff(g, w) <= TOL and _maxdiff(g, j) <= TOL


@pytest.mark.parametrize("compute", ["auto", "highest", "split_bf16"])
@pytest.mark.parametrize("space,rng", COLORIMETRY)
def test_resize_within_one_code_of_golden_and_jax(space, rng, compute):
    rgb = _rgb((2, 96, 128, 3), 22)
    oh, ow = 48, 64
    got = _np(encode_feed(rgb, out_h=oh, out_w=ow, space=space, rng=rng,
                          compute=compute, **CPU))
    want = _golden_feed(rgb, oh, ow, space, rng)
    jcompute = "split_bf16" if compute == "split_bf16" else "highest"
    jax_ = _jax("encode_feed", rgb, space, rng, out_h=oh, out_w=ow,
                compute=jcompute)
    for g, w, j in zip(got, want, jax_):
        assert g.dtype == np.uint8 and g.shape == w.shape == j.shape
        assert _maxdiff(g, w) <= TOL
        assert _maxdiff(g, j) <= TOL


def test_upscale_and_columns_first():
    """A target that contracts the columns first (the JAX package's
    choice by multiply-add count) and an upscale."""
    for shape, (oh, ow) in [((1, 40, 200, 3), (36, 40)),
                            ((1, 24, 32, 3), (48, 80))]:
        rgb = _rgb(shape, 23)
        got = _np(encode_feed(rgb, out_h=oh, out_w=ow, **CPU))
        want = _golden_feed(rgb, oh, ow, ColorSpace.BT_709, ColorRange.MPEG)
        jax_ = _jax("encode_feed", rgb, ColorSpace.BT_709, ColorRange.MPEG,
                    out_h=oh, out_w=ow, compute="highest")
        for g, w, j in zip(got, want, jax_):
            assert _maxdiff(g, w) <= TOL and _maxdiff(g, j) <= TOL


@pytest.mark.parametrize("space,rng", [(ColorSpace.BT_601, ColorRange.JPEG),
                                       (ColorSpace.BT_709, ColorRange.MPEG)])
def test_gray_within_one_code(space, rng):
    rgb = _rgb((2, 96, 128, 3), 24)
    oh, ow = 47, 63  # odd sizes are fine without the 4:2:0 fold
    got = encode_feed_gray(rgb, out_h=oh, out_w=ow, space=space, rng=rng,
                           **CPU).numpy()
    m, off = cs.ycbcr_from_rgb_matrix(space, rng)
    want = golden._round_u8(_golden_resized(rgb, oh, ow) @ m[0] + off[0])
    jax_ = _jax("encode_feed_gray", rgb, space, rng, out_h=oh, out_w=ow,
                compute="highest")
    assert got.shape == (2, oh, ow) == jax_.shape
    assert _maxdiff(got, want) <= TOL and _maxdiff(got, jax_) <= TOL


def test_gray_defaults_are_full_range_bt601():
    rgb = _rgb((1, 32, 32, 3), 25)
    a = encode_feed_gray(rgb, out_h=32, out_w=32, **CPU)
    b = encode_feed_gray(rgb, out_h=32, out_w=32, space=ColorSpace.BT_601,
                         rng=ColorRange.JPEG, **CPU)
    assert torch.equal(a, b)


def test_float_input_and_swap():
    rgbf = np.random.default_rng(26).random((1, 32, 64, 3), np.float32)
    y1, u1, v1 = _np(encode_feed(rgbf, out_h=32, out_w=64, **CPU))
    rgb_u8 = np.rint(rgbf * 255.0).astype(np.uint8)
    y2, u2, v2 = _np(encode_feed(rgb_u8, out_h=32, out_w=64, **CPU))
    assert _maxdiff(y1, y2) <= 1
    jy = np.asarray(jfused.encode_feed(rgbf, out_h=32, out_w=64,
                                       compute="highest")[0])
    assert _maxdiff(y1, jy) <= TOL
    y3, _, _ = _np(encode_feed(rgb_u8[..., ::-1].copy(), out_h=32, out_w=64,
                               swap=True, **CPU))
    np.testing.assert_array_equal(y3, y2)
    # a float tensor is taken on its own device
    yt, _, _ = encode_feed(torch.from_numpy(rgbf), out_h=32, out_w=64)
    np.testing.assert_array_equal(yt.numpy(), y1)


def test_planes_to_host_packed_equals_jax_and_feeds_the_encoder():
    from videoprocessingframework_torch.io.encoder import VideoEncoder

    rgb = _rgb((4, 96, 128, 3), 27)
    planes = encode_feed(rgb, out_h=64, out_w=96, **CPU)
    packed = planes_to_host_packed(*planes)
    assert isinstance(packed, np.ndarray) and packed.shape == (4, 96, 96)
    np.testing.assert_array_equal(
        packed, np.asarray(jfused.planes_to_host_packed(*_np(planes))))
    np.testing.assert_array_equal(planes_to_host_packed(*_np(planes)), packed)
    enc = VideoEncoder({"codec": "h264", "preset": "P1", "fmt": "YUV420",
                        "s": "96x64", "bitrate": "1M", "gop": "16"})
    pkts = [out[0] for out in map(enc.encode, packed) if out is not None]
    pkts.extend(p for p, _ in enc.flush())
    assert len(pkts) == 4


def test_validation_errors():
    rgb = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(ValueError, match="even"):
        encode_feed(rgb, out_h=33, out_w=32, **CPU)
    with pytest.raises(ValueError, match="RGB"):
        encode_feed(np.zeros((1, 32, 32, 4), np.uint8), out_h=32, out_w=32,
                    **CPU)
    with pytest.raises(ValueError, match="RGB"):
        encode_feed_gray(np.zeros((32, 32, 3), np.uint8), out_h=32,
                         out_w=32, **CPU)
    with pytest.raises(ValueError, match="compute"):
        encode_feed(rgb, out_h=16, out_w=16, compute="split-bf16", **CPU)
    y = np.zeros((1, 30, 32), np.uint8)
    c = np.zeros((1, 15, 16), np.uint8)
    with pytest.raises(ValueError, match="height % 4"):
        planes_to_host_packed(y, c, c)


def test_host_data_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_feed(np.zeros((1, 32, 32, 3), np.uint8), out_h=16, out_w=16)


@pytest.mark.cuda
def test_cuda_matches_cpu_and_refuses_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rgb = _rgb((2, 96, 128, 3), 28)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            encode_feed(rgb, out_h=48, out_w=64)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    got = encode_feed(rgb, out_h=48, out_w=64)
    cpu = encode_feed(rgb, out_h=48, out_w=64, **CPU)
    for g, c in zip(got, cpu):
        assert g.is_cuda and _maxdiff(g.cpu().numpy(), c.numpy()) <= TOL
    packed = planes_to_host_packed(*got)
    np.testing.assert_array_equal(
        packed, planes_to_host_packed(*(g.cpu() for g in got)))
