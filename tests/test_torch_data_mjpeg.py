"""The port's MjpegClipLoader (data/mjpeg.py) against the JAX package's
(mirrors tests/test_data_mjpeg.py).

Bars: the same (seed, epoch) gives the same windows, labels and decoded
planes (bit-equal: the planes are one float32 product in both), on any
worker count; fused ``rgb_u8`` ≤1 code and ``normalized`` ≤1e-5 from
JAX's at ``compute="highest"``; augmentation: JAX's program draws its
params from threefry, which the port does not reproduce, so the params
JAX draws for a batch are applied to the port's planes and held to JAX's
batch at PR 5's bars (crop on: ≤2e-4 ``normalized``, ≤1 code
``rgb_u8``). Then resume (plain and augmented), the pinned-configuration
guards, gray and 4:4:4 corpora, and
``BucketedClipLoader(loader_cls=MjpegClipLoader)`` on mixed geometry.
The loader on the card is marked ``cuda``.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_torch.core.enums import (
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.data import (
    AugmentSpec,
    BucketedClipLoader,
    MjpegClipLoader,
)
from videoprocessingframework_torch.io import MjpegReader, MjpegWriter
from videoprocessingframework_torch.io.jpeg import (
    JpegCoefEncoder,
    JpegStreamError,
)
from videoprocessingframework_torch.ops import augment as ta
from videoprocessingframework_torch.ops.jpeg import JpegDeviceEncoder
from videoprocessingframework_tpu import data as jdata

W, H, N = 96, 64, 14
CPU = dict(device="cpu")


def _mk_avi(path, n=N, seed=0, w=W, h=H, quality=90, sampling="420"):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip((yy + xx) * 255 / (h + w) + rng.normal(0, 4, (n, h, w)),
                0, 255).astype(np.uint8)
    ch, cw = (h // 2, w // 2) if sampling == "420" else (h, w)
    u = np.clip(128 + rng.normal(0, 6, (n, ch, cw)), 0, 255).astype(np.uint8)
    v = np.clip(128 - rng.normal(0, 6, (n, ch, cw)), 0, 255).astype(np.uint8)
    with MjpegWriter(str(path), w, h, quality=quality, container="avi",
                     sampling=sampling, **CPU) as wr:
        wr.write_planes(y, u, v)
    return str(path)


@pytest.fixture(scope="module")
def avis(tmp_path_factory):
    d = tmp_path_factory.mktemp("mjc")
    return _mk_avi(d / "a.avi"), _mk_avi(d / "b.avi", seed=9)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _maxdiff(a, b) -> float:
    return float(np.abs(_np(a).astype(np.float64)
                        - _np(b).astype(np.float64)).max())


@pytest.mark.parametrize("workers", [1, 3])
def test_windows_labels_planes_equal_jax(avis, workers):
    kw = dict(clip_len=3, frame_stride=2, batch_size=2, output="planes",
              shuffle=True, seed=5, labels=[4, 6])
    ld = MjpegClipLoader(list(avis), workers=workers, **kw, **CPU)
    jld = jdata.MjpegClipLoader(list(avis), workers=1, **kw)
    assert np.array_equal(ld.sampler.epoch(1), jld.sampler.epoch(1))
    got, want = list(ld.epoch(1)), list(jld.epoch(1))
    assert len(got) == len(want) == len(ld)
    for (planes, labels), (jplanes, jlabels) in zip(got, want):
        assert np.array_equal(labels, jlabels)
        assert planes[0].shape[1:] == (3, H, W)
        for p, j in zip(planes, jplanes):
            assert np.array_equal(_np(p), _np(j))


@pytest.mark.parametrize("output,tol", [("rgb_u8", 1), ("normalized", 1e-5)])
def test_fused_batches_vs_jax(avis, output, tol):
    kw = dict(clip_len=2, batch_size=3, out_size=(32, 48), output=output,
              seed=3, workers=1, compute="highest")
    got = list(MjpegClipLoader(avis[0], **kw, **CPU).epoch(0))
    want = list(jdata.MjpegClipLoader(avis[0], **kw).epoch(0))
    assert len(got) == len(want)
    for g, j in zip(got, want):
        assert g.shape[1:] == (2, 32, 48, 3)
        assert _maxdiff(g, j) <= tol


def test_clip_frames_equal_sequential_reader(avis):
    """Random access (all-intra seeks) gives the frames a sequential
    MjpegReader decodes."""
    T, stride = 3, 2
    seq = torch.cat(list(MjpegReader(avis[0], output="rgb_u8",
                                     **CPU).batches())).numpy()
    ld = MjpegClipLoader(avis[0], clip_len=T, frame_stride=stride,
                         batch_size=2, output="rgb_u8", seed=5, workers=1,
                         **CPU)
    got = torch.cat(list(ld.epoch(0))).numpy()
    samples = ld.sampler.epoch(0)
    assert got.shape == (len(samples), T, H, W, 3)
    for clip, (_, st) in zip(got, samples):
        assert np.array_equal(clip, seq[st: st + T * stride: stride])
    assert ld.stage_summary()["frames"]["kept"] == len(samples) * T


SPEC = dict(crop=True, crop_scale=(0.5, 1.0), hflip=0.5, brightness=0.2)


@pytest.mark.parametrize("output,tol", [("normalized", 2e-4),
                                        ("rgb_u8", 1)])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_augmented_batches_apply_jax_params(avis, output, tol, shard):
    """JAX's augmented batches equal the port's augment_postproc applied
    to the port's planes with the params JAX's program draws at the
    loader's shard-unique counter."""
    import jax

    from videoprocessingframework_tpu.ops import augment as ja

    seed, epoch, (si, sc) = 7, 1, shard
    kw = dict(clip_len=2, batch_size=2, seed=seed, workers=1,
              shard_index=si, shard_count=sc, shuffle=True)
    jaug = list(jdata.MjpegClipLoader(
        avis[0], out_size=(32, 32), output=output,
        augment=jdata.AugmentSpec(**SPEC), **kw).epoch(epoch))
    planes = list(MjpegClipLoader(avis[0], output="planes", **kw,
                                  **CPU).epoch(epoch))
    assert len(jaug) == len(planes) > 1
    for idx, (jb, pb) in enumerate(zip(jaug, planes)):
        b = pb[0].shape[0]
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), epoch), idx * sc + si)
        params = jax.tree.map(np.array, ja.sample_augment_params(
            key, b, H, W, ja.AugmentSpec(**SPEC)))
        got = ta.augment_postproc(
            *(p.reshape(-1, *p.shape[2:]) for p in pb), params=params,
            src_format=PixelFormat.YUV420, space=ColorSpace.BT_601,
            rng=ColorRange.JPEG, out_h=32, out_w=32, output=output,
            spec=ta.AugmentSpec(**SPEC), clip_len=2)
        assert _maxdiff(got.reshape(_np(jb).shape), jb) <= tol


def test_augmented_loader_is_the_counter_stream_and_resumes(avis):
    """The port's augmented batches are augment_postproc of its planes
    with AugmentPipeline's params at (seed, epoch, index); a second
    loader repeats them; a mid-epoch resume continues them exactly."""
    spec = ta.AugmentSpec(**SPEC)
    kw = dict(clip_len=2, batch_size=2, out_size=(32, 32), output="rgb_u8",
              seed=7, workers=1, **CPU)
    ld = MjpegClipLoader(avis[0], augment=spec, **kw)
    full = [b.numpy() for b in ld.epoch(1)]
    again = MjpegClipLoader(avis[0], augment=spec, **kw).epoch(1)
    assert all(np.array_equal(x.numpy(), y) for x, y in zip(again, full))
    planes = list(MjpegClipLoader(avis[0], **{**kw, "output": "planes"})
                  .epoch(1))
    sampler = ta.AugmentPipeline(PixelFormat.YUV420, ColorSpace.BT_601,
                                 ColorRange.JPEG, (32, 32), spec, clip_len=2,
                                 seed=7, **CPU)
    for idx, (pb, want) in enumerate(zip(planes, full)):
        params = sampler.sample(pb[0].shape[0], H, W, 1, idx)
        got = ta.augment_postproc(
            *(p.reshape(-1, *p.shape[2:]) for p in pb), params=params,
            src_format=PixelFormat.YUV420, space=ColorSpace.BT_601,
            rng=ColorRange.JPEG, out_h=32, out_w=32, output="rgb_u8",
            spec=spec, clip_len=2)
        assert np.array_equal(got.reshape(want.shape).numpy(), want)
    plain = next(iter(MjpegClipLoader(avis[0], **kw).epoch(1))).numpy()
    assert (plain != full[0]).any()
    it = ld.epoch(1)
    first = next(it).numpy()
    state = ld.state_dict()
    del it
    ld2 = MjpegClipLoader(avis[0], augment=spec, **kw)
    ld2.load_state_dict(state)
    rest = [b.numpy() for b in ld2.epoch()]
    assert np.array_equal(first, full[0]) and len(rest) == len(full) - 1
    for x, y in zip(rest, full[1:]):
        assert np.array_equal(x, y)


def test_guards(avis, test_mp4, tmp_path):
    with pytest.raises(JpegStreamError, match="not MJPEG"):
        MjpegClipLoader([test_mp4], clip_len=2, **CPU)
    other = _mk_avi(tmp_path / "q50.avi", quality=50)
    with pytest.raises(JpegStreamError, match="quant tables"):
        MjpegClipLoader([avis[0], other], clip_len=2, **CPU)
    with pytest.raises(ValueError, match="planes"):
        MjpegClipLoader(avis[0], output="planes", augment=AugmentSpec(),
                        **CPU)
    with pytest.raises(TypeError, match="AugmentSpec"):
        MjpegClipLoader(avis[0], augment={"crop": True}, **CPU)
    # adaptive-DQT stream: the tables change at frame 3
    p = tmp_path / "adaptive.mjpeg"
    rng = np.random.default_rng(0)
    with open(p, "wb") as f:
        for q in (90, 90, 90, 50, 50, 50):
            enc = JpegDeviceEncoder(H, W, quality=q, **CPU)
            ce = JpegCoefEncoder(W, H, quant_tables=enc.quant_tables)
            planes = (rng.integers(0, 256, (1, H, W), np.uint8),
                      rng.integers(0, 256, (1, H // 2, W // 2), np.uint8),
                      rng.integers(0, 256, (1, H // 2, W // 2), np.uint8))
            f.write(ce.encode(*(c[0] for c in enc.encode_planes(*planes))))
    ld = MjpegClipLoader(str(p), clip_len=2, batch_size=2, output="rgb_u8",
                         shuffle=False, workers=1, lengths=[6], **CPU)
    with pytest.raises(JpegStreamError, match="quant tables changed"):
        list(ld.epoch(0))


def test_gray_and_444_corpora_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    g = tmp_path / "g.mjpeg"
    enc = JpegDeviceEncoder(H, W, quality=90, subsampled="gray", **CPU)
    ce = JpegCoefEncoder(W, H, quant_tables=enc.quant_tables,
                         subsampled="gray")
    with open(g, "wb") as f:
        for _ in range(6):
            (cy,) = enc.encode_planes(rng.integers(0, 256, (1, H, W),
                                                   np.uint8))
            f.write(ce.encode(cy[0]))
    kw = dict(clip_len=2, batch_size=2, shuffle=True, seed=1, workers=1,
              lengths=[6])
    ld = MjpegClipLoader(str(g), output="rgb_u8", **kw, **CPU)
    assert ld.ncomp == 1
    batch = next(iter(ld.epoch(0))).numpy()
    assert batch.shape == (2, 2, H, W, 3)
    assert np.array_equal(batch[..., 0], batch[..., 1])
    (got,) = next(iter(MjpegClipLoader(str(g), output="planes", **kw,
                                       **CPU).epoch(0)))
    (want,) = next(iter(jdata.MjpegClipLoader(str(g), output="planes",
                                              **kw).epoch(0)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    p = _mk_avi(tmp_path / "c444.avi", n=6, sampling="444")
    kw = dict(clip_len=2, batch_size=2, output="planes", shuffle=False,
              workers=1)
    got = next(iter(MjpegClipLoader(p, **kw, **CPU).epoch(0)))
    want = next(iter(jdata.MjpegClipLoader(p, **kw).epoch(0)))
    assert got[1].shape == (2, 2, H, W)  # full-resolution chroma
    for x, y in zip(got, want):
        assert np.array_equal(x.numpy(), np.asarray(y))


def test_bucketed_mjpeg_equals_jax(tmp_path):
    a = _mk_avi(tmp_path / "ba.avi", n=8, seed=1)
    b = _mk_avi(tmp_path / "bb.avi", n=8, seed=2, w=64, h=48)
    kw = dict(out_size=(32, 32), clip_len=2, batch_size=2, labels=[3, 5],
              seed=6, workers=1, compute="highest")
    ld = BucketedClipLoader([a, b], loader_cls=MjpegClipLoader,
                            output="rgb_u8", **kw, **CPU)
    jld = jdata.BucketedClipLoader([a, b], loader_cls=jdata.MjpegClipLoader,
                                   output="rgb_u8", **kw)
    assert len(ld.loaders) == 2
    assert all(isinstance(x, MjpegClipLoader) for x in ld.loaders)
    total, seen = 0, set()
    for (x, lx), (y, ly) in zip(ld.epoch(0), jld.epoch(0)):
        assert x.shape[1:] == (2, 32, 32, 3)
        assert np.array_equal(lx, ly) and _maxdiff(x, y) <= 1
        total += x.shape[0]
        seen.update(lx.tolist())
    assert total == ld.clips_per_epoch and seen == {3, 5}


@pytest.mark.cuda
def test_loader_cuda_matches_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from videoprocessingframework_torch.io.build import libav_missing

    if libav_missing():
        pytest.skip(f"the loader demuxes through libav: {libav_missing()}")
    from videoprocessingframework_torch.csrc import launch

    avi = _mk_avi(tmp_path / "a.avi")
    kw = dict(clip_len=2, batch_size=4, output="planes", seed=2, workers=2)
    for got, want in zip(MjpegClipLoader(avi, **kw).epoch(0),
                         MjpegClipLoader(avi, **kw, **CPU).epoch(0)):
        for g, w in zip(got, want):
            assert g.is_cuda and _maxdiff(g.cpu(), w) <= 1
    launch.reset_launches()
    batches = list(MjpegClipLoader(avi, **{**kw, "output": "rgb_u8"},
                                   out_size=(32, 32)).epoch(0))
    assert launch.LAUNCHES["fused_resize_csc"] == len(batches) > 0
