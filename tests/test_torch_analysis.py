"""The port's analysis ops (ops/metrics.py, flow.py, stabilize.py,
scenecut.py) against the JAX package's, on the same seeded inputs, on the
CPU. Both sides compute in float32 in different orders; each comparison
states its tolerance. One test holds a CUDA run against the CPU (marked
``cuda``; it skips without a card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_flow import _shifted_pair, _smooth_texture
from videoprocessingframework_tpu.ops import flow as jflow
from videoprocessingframework_tpu.ops import metrics as jmetrics
from videoprocessingframework_tpu.ops import scenecut as jscene
from videoprocessingframework_tpu.ops import stabilize as jstab
from videoprocessingframework_torch.ops import flow, metrics, scenecut
from videoprocessingframework_torch.ops import stabilize

CPU = dict(device="cpu")
#: the rows of GetMotionVectors() (the JAX package's compat.MotionVector;
#: compat imports the host I/O runtime, which these tests do not need)
MotionVector = np.dtype([
    ("source", np.int32), ("w", np.uint8), ("h", np.uint8),
    ("src_x", np.int16), ("src_y", np.int16), ("dst_x", np.int16),
    ("dst_y", np.int16), ("flags", np.uint64), ("motion_x", np.int32),
    ("motion_y", np.int32), ("motion_scale", np.uint16),
])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pairs(shape, seed):
    r = np.random.default_rng(seed)
    a = r.integers(0, 256, shape, np.uint8)
    noise = r.integers(-12, 13, shape)
    return a, np.clip(a.astype(np.int64) + noise, 0, 255).astype(np.uint8)


# ---- metrics ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 40, 56), (2, 33, 47, 3)])
def test_metrics_match_jax(shape):
    a, b = _pairs(shape, seed=len(shape))
    b[0] = a[0]  # identical pair: PSNR is inf on both sides
    got = _np(metrics.psnr(a, b, **CPU))
    want = _np(jmetrics.psnr(a, b))
    assert np.isinf(got[0]) and np.isinf(want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5)
    for fn in ("ssim", "ms_ssim"):
        got = _np(getattr(metrics, fn)(a, b, **CPU))
        want = _np(getattr(jmetrics, fn)(a, b))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=fn)


def test_ms_ssim_level_count_and_tensors():
    """Small frames drop scales (weights renormalised); tensors stay on
    their device and keep their values."""
    a, b = _pairs((2, 15, 70), seed=9)  # 15 // 2 < 8: one level
    want = _np(jmetrics.ms_ssim(a, b))
    got = _np(metrics.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _np(jmetrics.ssim(a, b)), rtol=1e-5)


# ---- flow -------------------------------------------------------------------


# 96×128 halves evenly; 75×101 gives levels of 38×51 and 19×26, so the
# coarse-to-fine upsample runs at ratios other than 2
@pytest.mark.parametrize("h,w", [(96, 128), (75, 101)])
def test_lucas_kanade_matches_jax(h, w):
    prev, nxt = _shifted_pair(h, w, 3.0, -2.0, seed=h)
    p, n = prev[None].repeat(2, 0), nxt[None].repeat(2, 0)
    n[1] = np.roll(n[1], 1, axis=1)
    got = _np(flow.lucas_kanade_flow(p, n, iters=4, **CPU))
    want = _np(jflow.lucas_kanade_flow(p, n, iters=4))
    assert got.shape == want.shape == (2, h, w, 2)
    # float32 iterations in another order (measured: 2e-5 px)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_lucas_kanade_u8_channels_and_errors():
    prev, nxt = _shifted_pair(64, 96, 1.0, 0.5, seed=3)
    rgb_p = np.repeat(prev[None, ..., None], 3, -1).astype(np.uint8)
    rgb_n = np.repeat(nxt[None, ..., None], 3, -1).astype(np.uint8)
    got = _np(flow.lucas_kanade_flow(rgb_p, rgb_n, **CPU))
    want = _np(jflow.lucas_kanade_flow(rgb_p, rgb_n))
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(ValueError, match="differ"):
        flow.lucas_kanade_flow(np.zeros((1, 32, 32), np.uint8),
                               np.zeros((1, 32, 48), np.uint8), **CPU)


def test_warp_and_midpoint_match_jax():
    prev, mid = _shifted_pair(64, 96, 2.0, 1.5, seed=4)
    _, nxt = _shifted_pair(64, 96, 4.0, 3.0, seed=4)
    fl = jflow.lucas_kanade_flow(prev[None], nxt[None])
    fl_np = np.asarray(fl)
    for img in (nxt[None], nxt[None].astype(np.uint8),
                np.repeat(nxt[None, ..., None], 3, -1)):
        got = _np(flow.warp_image(img, fl_np, scale=0.5, **CPU))
        want = _np(jflow.warp_image(jnp.asarray(img), fl, scale=0.5))
        assert got.dtype == want.dtype and got.shape == want.shape
        # u8: one code where a value sits on a rounding boundary
        tol = 1 if img.dtype == np.uint8 else 1e-4
        assert np.abs(got.astype(np.float64) - want).max() <= tol
    for p, n in ((prev, nxt), (prev.astype(np.uint8), nxt.astype(np.uint8))):
        got = _np(flow.interpolate_midpoint(p[None], n[None], **CPU))
        want = _np(jflow.interpolate_midpoint(p[None], n[None]))
        assert got.dtype == want.dtype
        tol = 1 if p.dtype == np.uint8 else 1e-3
        assert np.abs(got.astype(np.float64) - want).max() <= tol


def test_mv_to_dense_flow_matches_jax():
    r = np.random.default_rng(6)
    mvs = np.zeros((12,), MotionVector)
    for k, lo, hi in (("source", -1, 2), ("w", 4, 17), ("h", 4, 17),
                      ("dst_x", -4, 40), ("dst_y", -4, 24),
                      ("motion_x", -9, 10), ("motion_y", -9, 10),
                      ("motion_scale", 0, 5)):
        mvs[k] = r.integers(lo, hi, 12)
    for m in (mvs, mvs[:0], None):
        np.testing.assert_array_equal(flow.mv_to_dense_flow(m, 36, 20),
                                      jflow.mv_to_dense_flow(m, 36, 20))


# ---- stabilize --------------------------------------------------------------


def _jittered_clip(n=8, h=72, w=96, seed=4, amp=3):
    rng = np.random.default_rng(seed)
    jitter = rng.integers(-amp, amp + 1, (n, 2))
    jitter[0] = 0
    pad = 16
    big = _smooth_texture(h + 2 * pad, w + 2 * pad, seed=seed)
    return np.stack([big[pad + jy:pad + jy + h, pad + jx:pad + jx + w]
                     for jx, jy in jitter]).astype(np.float32)


def test_median_of_even_count_averages_middle_pair():
    r = np.random.default_rng(7)
    for n in (10, 11):  # even and odd counts
        x = r.standard_normal((3, n, 2)).astype(np.float32)
        got = stabilize.median(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.median(x, axis=1)))


def test_global_translations_and_smooth_path_match_jax():
    frames = _jittered_clip()
    got = _np(stabilize.global_translations(frames, iters=4, **CPU))
    want = _np(jstab.global_translations(frames, iters=4))
    # interior of (72 − 32) × (96 − 32) = 2560 samples: an even count
    np.testing.assert_allclose(got, want, atol=1e-4)
    path = np.cumsum(np.random.default_rng(8).standard_normal((20, 2)), 0)
    np.testing.assert_array_equal(stabilize.smooth_path(path, 3.0),
                                  jstab.smooth_path(path, 3.0))
    with pytest.raises(ValueError, match="interior"):
        stabilize.global_translations(frames[:, :30], **CPU)


@pytest.mark.parametrize("channels", [False, True])
def test_stabilize_clip_matches_jax(channels):
    frames = _jittered_clip(n=6)
    if channels:
        frames = np.repeat(frames[..., None], 3, -1).astype(np.uint8)
    out, corr = stabilize.stabilize_clip(frames, sigma=3.0, **CPU)
    want_out, want_corr = jstab.stabilize_clip(frames, sigma=3.0)
    assert out.shape == want_out.shape and out.dtype == want_out.dtype
    np.testing.assert_allclose(corr, want_corr, atol=1e-4)
    # corrections 1e-4 px apart move a warped value by far less than a
    # code: u8 may flip one code at a rounding boundary
    tol = 1.0 if channels else 1e-2
    assert np.abs(out.astype(np.float64) - want_out).max() <= tol


# ---- scene cuts -------------------------------------------------------------


def _spliced_clip():
    def shot(n, step, seed):
        pad = 8 + 2 * n
        big = _smooth_texture(72 + 2 * pad, 96 + 2 * pad, seed=seed)
        return np.stack([big[pad + step[1] * i:pad + step[1] * i + 72,
                             pad + step[0] * i:pad + step[0] * i + 96]
                         for i in range(n)])

    return np.concatenate([shot(8, (1, 0), 1), shot(6, (0, 1), 7),
                           shot(7, (-1, 1), 13)]).astype(np.uint8)


def test_scene_cut_scores_and_cuts_match_jax():
    clip = _spliced_clip()
    got = _np(scenecut.scene_cut_scores(clip, **CPU))
    want = _np(jscene.scene_cut_scores(clip))
    assert got.shape == (20,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert scenecut.detect_cuts(got) == jscene.detect_cuts(want) == [7, 13]
    assert scenecut.detect_cuts(torch.from_numpy(got)) == [7, 13]
    assert scenecut.detect_cuts(np.zeros(0)) == []
    with pytest.raises(ValueError, match="luma"):
        scenecut.scene_cut_scores(np.zeros((4, 32, 32, 3), np.uint8), **CPU)


def test_soft_histogram_bins_match_jax():
    x = np.random.default_rng(10).uniform(0, 255, (3, 36, 44)).astype(
        np.float32)
    for bins in (2, 16, 32):
        got = scenecut._soft_histogram(torch.from_numpy(x), bins).numpy()
        want = np.asarray(jscene._soft_histogram(jnp.asarray(x), bins))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# ---- on the card ------------------------------------------------------------


@pytest.mark.cuda
def test_analysis_ops_cuda_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev, nxt = _shifted_pair(75, 101, 3.0, -2.0, seed=11)
    p, n = torch.from_numpy(prev[None]), torch.from_numpy(nxt[None])
    cpu = flow.lucas_kanade_flow(p, n)
    gpu = flow.lucas_kanade_flow(p.cuda(), n.cuda())
    assert gpu.is_cuda
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), atol=1e-3)
    clip = torch.from_numpy(_spliced_clip())
    np.testing.assert_allclose(
        scenecut.scene_cut_scores(clip.cuda()).cpu().numpy(),
        scenecut.scene_cut_scores(clip).numpy(), rtol=1e-4, atol=1e-5)
    a, b = _pairs((2, 33, 47, 3), seed=12)
    np.testing.assert_allclose(metrics.ms_ssim(a, b).cpu().numpy(),
                               metrics.ms_ssim(a, b, **CPU).numpy(),
                               rtol=1e-5, atol=1e-6)
