"""The port's augmentation (ops/augment.py) against the JAX package's:
interpolation matrices against ``resize_matrix``; ``augment_postproc``
given the params JAX draws (``sample_augment_params`` with the key JAX's
program derives from its counter) against JAX's program; ``mixup_cutmix``
given JAX's draws; the port's own samplers (ranges, determinism per
counter, crop boxes inside the frame); the augmenting pipeline on the
card against the CPU (marked ``cuda``).

Tolerances, in the output's units:

* crop off (flip, jitter, time reversal on): ≤1e-5 ``normalized``, ≤1
  code ``rgb_u8`` (a rounding boundary);
* crop on: ≤2e-4 ``normalized``, ≤1 code. A crop window's matrices are
  built in float32 from positions ``start + (i+0.5)·scale − 0.5``, and
  XLA's fused program rounds those otherwise than op-by-op evaluation:
  its matrices differ from the same function run eagerly by 8.5e-6, and
  both lie ~5e-6 from float64, about 2e-3 codes after the resize (9e-5
  ``normalized`` measured, seeds 0-5);
* ``mixup_cutmix``: pixels ≤1e-6, soft labels exactly.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_torch.core.enums import (
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.ops import augment as ta
from videoprocessingframework_torch.ops.fused import decode_postproc
from videoprocessingframework_torch.ops.resize import resize_matrix

B, T, H, W = 4, 2, 48, 64
OH, OW = 24, 32
JITTER = dict(hflip=0.5, brightness=0.3, contrast=0.3, saturation=0.3,
              hue=0.1, time_reverse=0.5)


def _packed(seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (B * T, H * 3 // 2, W), np.uint8)


def _jax_case(spec_kw, seed, epoch, idx, out, packed):
    """JAX's augment_postproc at counter (seed, epoch, idx), and the params
    its program draws (the key as augment.py builds it from the
    counter)."""
    import jax

    from videoprocessingframework_tpu.core.enums import (
        ColorRange as JR,
        ColorSpace as JS,
        PixelFormat as JP,
    )
    from videoprocessingframework_tpu.ops import augment as ja

    spec = ja.AugmentSpec(**spec_kw)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                epoch), idx)
    params = jax.tree.map(np.array,
                          ja.sample_augment_params(key, B, H, W, spec))
    want = np.asarray(ja.augment_postproc(
        packed, np.asarray([seed, epoch, idx], np.uint32),
        src_format=JP.YUV420, space=JS.BT_709, rng=JR.MPEG, out_h=OH,
        out_w=OW, output=out, spec=spec, clip_len=T))
    return params, want


def _port(packed, params, spec_kw, out):
    return ta.augment_postproc(
        torch.from_numpy(packed), params=params,
        src_format=PixelFormat.YUV420, space=ColorSpace.BT_709,
        rng=ColorRange.MPEG, out_h=OH, out_w=OW, output=out,
        spec=ta.AugmentSpec(**spec_kw), clip_len=T).numpy()


# the matrices' source positions are float32: at 1080 rows half an ulp
# (3e-5) moves a Lanczos weight by up to 1.4e-4 against the float64
# construction of resize_matrix
@pytest.mark.parametrize("method", ["lanczos", "bilinear"])
@pytest.mark.parametrize("n_in,n_out,tol", [(48, 24, 1e-6), (64, 32, 1e-6),
                                            (30, 64, 1e-6),
                                            (1080, 224, 2e-4)])
def test_window_matrices_full_window_equal_resize_matrix(method, n_in, n_out,
                                                         tol):
    import jax.numpy as jnp

    from videoprocessingframework_tpu.ops.augment import (
        window_matrices as jax_window_matrices,
    )

    start = torch.zeros(2)
    length = torch.full((2,), float(n_in))
    got = ta.window_matrices(start, length, n_in, n_out, method).numpy()
    assert got.shape == (2, n_out, n_in)
    assert np.array_equal(got[0], got[1])
    want = resize_matrix(n_in, n_out, method)
    assert np.abs(got[0] - want).max() <= tol
    # and the JAX package's function, run op by op like torch
    r = np.random.default_rng(n_in)
    s = r.uniform(0, n_in / 4, 3).astype(np.float32)
    ln = r.uniform(n_in / 2, 3 * n_in / 4, 3).astype(np.float32)
    jw = np.asarray(jax_window_matrices(jnp.asarray(s), jnp.asarray(ln),
                                        n_in, n_out, method))
    tw = ta.window_matrices(torch.from_numpy(s), torch.from_numpy(ln), n_in,
                            n_out, method).numpy()
    assert np.abs(tw - jw).max() <= 1e-6


@pytest.mark.parametrize("idx", range(3))
@pytest.mark.parametrize("out,tol", [("normalized", 1e-5), ("rgb_u8", 1),
                                     ("rgb_f32", 1e-5 / 4),
                                     ("normalized_nchw", 1e-5)])
def test_jax_params_crop_off(out, tol, idx):
    spec_kw = dict(crop=False, **JITTER)
    packed = _packed(idx)
    params, want = _jax_case(spec_kw, 5, 1, idx, out, packed)
    got = _port(packed, params, spec_kw, out)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.float64) - want).max() <= tol


@pytest.mark.parametrize("idx", range(3))
@pytest.mark.parametrize("out,tol", [("normalized", 2e-4), ("rgb_u8", 1)])
def test_jax_params_crop_on(out, tol, idx):
    spec_kw = dict(crop=True, crop_scale=(0.5, 1.0), **JITTER)
    packed = _packed(idx)
    params, want = _jax_case(spec_kw, 7, 2, idx, out, packed)
    assert not np.all(params["ch"] == H)  # the crops are real
    got = _port(packed, params, spec_kw, out)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.float64) - want).max() <= tol


def test_identity_spec_equals_decode_postproc():
    """Crop, flip and jitter off: the fused post-processing itself."""
    packed = _packed(3)
    spec_kw = dict(crop=False, hflip=0.0)
    params = ta.sample_augment_params(B, H, W, ta.AugmentSpec(**spec_kw),
                                      torch.Generator().manual_seed(0))
    got = _port(packed, params, spec_kw, "normalized")
    want = decode_postproc(
        torch.from_numpy(packed), src_format=PixelFormat.YUV420,
        space=ColorSpace.BT_709, rng=ColorRange.MPEG, out_h=OH, out_w=OW,
        output="normalized").numpy()
    assert np.abs(got - want).max() <= 1e-5


def _jax_mixup(x, labels, seed, **kw):
    """JAX's mixup_cutmix and its draws, split from the key as it does."""
    import jax
    import jax.numpy as jnp

    from videoprocessingframework_tpu.ops.augment import mixup_cutmix

    key = jax.random.PRNGKey(seed)
    mixed, soft = mixup_cutmix(x, labels, key, num_classes=5, **kw)
    n = x.shape[0]
    kl, kc, kg, kx, ky = jax.random.split(key, 5)
    ma, ca = kw["mixup_alpha"], kw["cutmix_alpha"]
    use_cut = (jax.random.uniform(kc, (n,)) < kw["switch_prob"]
               if ca > 0 and ma > 0 else jnp.full((n,), ca > 0))

    def beta(a):
        return (jax.random.beta(kl, a, a, (n,)).astype(jnp.float32) if a > 0
                else jnp.ones((n,), jnp.float32))

    params = dict(lam=jnp.where(use_cut, beta(ca), beta(ma)),
                  use_cut=use_cut,
                  gate=jax.random.uniform(kg, (n,)) < kw["prob"],
                  cy=jax.random.uniform(ky, (n,)),
                  cx=jax.random.uniform(kx, (n,)))
    return (np.asarray(mixed), np.asarray(soft),
            jax.tree.map(np.array, params))


@pytest.mark.parametrize("shape", [(6, 10, 12, 3), (6, 2, 10, 12, 3)])
@pytest.mark.parametrize("alphas", [(0.4, 1.0), (0.4, 0.0), (0.0, 1.0)])
def test_mixup_cutmix_given_jax_draws(shape, alphas):
    r = np.random.default_rng(4)
    x = r.standard_normal(shape).astype(np.float32)
    labels = r.integers(0, 5, shape[0]).astype(np.int32)
    kw = dict(mixup_alpha=alphas[0], cutmix_alpha=alphas[1], switch_prob=0.5,
              prob=0.8)
    mixed, soft, params = _jax_mixup(x, labels, 9, **kw)
    got, got_soft = ta.mixup_cutmix(torch.from_numpy(x),
                                    torch.from_numpy(labels), params,
                                    num_classes=5)
    assert np.abs(got.numpy() - mixed).max() <= 1e-6
    assert np.array_equal(got_soft.numpy(), soft)


def test_mixup_rejects_bad_input():
    params = ta.sample_mixup_params(2, np.random.default_rng(0))
    with pytest.raises(ValueError, match="float"):
        ta.mixup_cutmix(torch.zeros(2, 4, 4, 3, dtype=torch.uint8),
                        torch.zeros(2), params, num_classes=3)
    with pytest.raises(ValueError, match="expects"):
        ta.mixup_cutmix(torch.zeros(2, 4, 3), torch.zeros(2), params,
                        num_classes=3)
    with pytest.raises(ValueError, match="alpha"):
        ta.sample_mixup_params(2, np.random.default_rng(0), mixup_alpha=0,
                               cutmix_alpha=0)


def test_mixup_soft_labels_match_pixels():
    """A CutMix label weight equals the pasted area exactly."""
    n, h, w = 8, 10, 12
    x = torch.zeros(n, h, w, 1)
    x[n // 2:] = 1.0  # the reversed partner of sample i < n/2 is all ones
    params = ta.sample_mixup_params(n, np.random.default_rng(1),
                                    mixup_alpha=0.0, cutmix_alpha=1.0)
    mixed, soft = ta.mixup_cutmix(x, torch.arange(n) % 4, params,
                                  num_classes=4)
    pasted = mixed[: n // 2].mean(dim=(1, 2, 3))
    own = soft[torch.arange(n // 2), torch.arange(n // 2) % 4]
    torch.testing.assert_close(1.0 - pasted, own, rtol=0, atol=1e-6)


def _spec():
    return ta.AugmentSpec(crop=True, crop_scale=(0.3, 1.0), **JITTER)


def test_sampler_ranges_and_boxes():
    spec = _spec()
    g = torch.Generator().manual_seed(ta.counter_seed(1, 2, 3))
    p = ta.sample_augment_params(4096, H, W, spec, g)
    y0, x0, ch, cw = (p[k].double() for k in ("y0", "x0", "ch", "cw"))
    eps = 1e-4
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + ch <= H + eps).all() and (x0 + cw <= W + eps).all()
    area = ch * cw / (H * W)
    assert area.max() <= 1.0 + eps
    # where the sample was feasible (not clamped), the area and aspect
    # are in range
    free = (ch < H) & (cw < W)
    assert (area[free] >= 0.3 - eps).all()
    ratio = (cw / ch)[free]
    assert (ratio >= 0.75 - eps).all() and (ratio <= 4 / 3 + eps).all()
    for k, amt in (("brightness", 0.3), ("contrast", 0.3),
                   ("saturation", 0.3)):
        assert (p[k] >= 1 - amt).all() and (p[k] <= 1 + amt).all()
    assert (p["hue"].abs() <= 0.1 * 2 * np.pi + 1e-6).all()
    for k in ("flip", "time_reverse"):
        assert p[k].dtype == torch.bool
        assert 0.4 < p[k].float().mean() < 0.6


def test_sampler_disabled_augmentations_are_identity():
    spec = ta.AugmentSpec(crop=False, hflip=0.0)
    p = ta.sample_augment_params(8, H, W, spec,
                                 torch.Generator().manual_seed(0))
    assert (p["ch"] == H).all() and (p["cw"] == W).all()
    assert (p["y0"] == 0).all() and (p["x0"] == 0).all()
    assert not p["flip"].any() and not p["time_reverse"].any()
    for k in ("brightness", "contrast", "saturation"):
        assert (p[k] == 1).all()
    assert (p["hue"] == 0).all()


def test_sampler_is_a_function_of_the_counter():
    pipe = ta.AugmentPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                              ColorRange.MPEG, (OW, OH), _spec(),
                              clip_len=T, seed=5, device="cpu")
    a = pipe.sample(B, H, W, epoch=1, batch_index=2)
    b = pipe.sample(B, H, W, epoch=1, batch_index=2)
    for k in ta.PARAM_KEYS:
        assert torch.equal(a[k], b[k])
    for other in ((1, 3), (2, 2)):
        c = pipe.sample(B, H, W, *other)
        assert not torch.equal(a["y0"], c["y0"])
    assert ta.counter_seed(5, 1, 2) == ta.counter_seed(5, 1, 2)
    assert ta.counter_seed(5, 1, 2) != ta.counter_seed(5, 2, 1)
    assert ta.counter_seed(5, 1, 2 + 2**32) == ta.counter_seed(5, 1, 2)
    # the pipeline applies what it samples
    packed = torch.from_numpy(_packed(2))
    got = pipe(packed, epoch=1, batch_index=2)
    assert torch.equal(got, pipe(packed, params=a))
    assert got.shape == (B * T, OH, OW, 3)
    m1 = ta.sample_mixup_params(B, np.random.default_rng(
        ta.counter_seed(5, 1, 2)))
    m2 = ta.sample_mixup_params(B, np.random.default_rng(
        ta.counter_seed(5, 1, 2)))
    for k in ta.MIXUP_KEYS:
        assert np.array_equal(m1[k], m2[k])
    assert ((m1["lam"] >= 0) & (m1["lam"] <= 1)).all()


def test_spec_and_pipeline_validation():
    with pytest.raises(ValueError, match="crop_scale"):
        ta.AugmentSpec(crop_scale=(0.0, 1.0))
    with pytest.raises(ValueError, match="hue"):
        ta.AugmentSpec(hue=0.6)
    with pytest.raises(ValueError, match="hflip"):
        ta.AugmentSpec(hflip=1.5)
    with pytest.raises(ValueError, match="lanczos"):
        ta.AugmentPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                           ColorRange.MPEG, (OW, OH), _spec(),
                           method="nearest", device="cpu")
    p = ta.sample_augment_params(B, H, W, _spec(),
                                 torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="clips"):
        _port(_packed()[:2 * T], p, dict(crop=True), "rgb_u8")
    with pytest.raises(ValueError, match="divisible"):
        _port(_packed()[:3], p, dict(crop=True), "rgb_u8")


@pytest.mark.cuda
def test_augment_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    packed = torch.from_numpy(_packed(5))
    kw = dict(clip_len=T, output="normalized", seed=3)
    args = (PixelFormat.YUV420, ColorSpace.BT_709, ColorRange.MPEG,
            (OW, OH), _spec())
    cpu = ta.AugmentPipeline(*args, device="cpu", **kw)
    gpu = ta.AugmentPipeline(*args, device="cuda", **kw)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = gpu(packed.cuda(), epoch=1, batch_index=4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = cpu(packed, epoch=1, batch_index=4)
    assert got.is_cuda
    assert (got.cpu() - want).abs().max().item() <= 1e-4
