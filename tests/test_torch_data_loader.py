"""The port's clip loaders (data/) against the JAX package's on
``tests/assets/test.mp4`` and seeded clips: the same (seed, epoch) gives
the same windows, frames and labels (bit-equal), fused batches within
1e-5 (``normalized``) / 1 code (``rgb_u8``); worker invariance,
``drop_last``, the shard split, mid-epoch resume (plain and augmented),
``BucketedClipLoader``, the unseekable-stream path and its typed error,
batches that never alias a ring slot, and the seeded-host loader. The
loader on the card against the CPU is marked ``cuda``.
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
    ClipSampler,
    HostClipLoader,
    VideoClipLoader,
    VideoCorpus,
)
from videoprocessingframework_torch.io.decoder import VideoReader
from videoprocessingframework_torch.ops.augment import augment_postproc
from videoprocessingframework_torch.ops.fused import decode_postproc

W, H, NFRAMES = 848, 464, 96  # tests/assets/test.mp4
ROWS = H * 3 // 2
CPU = dict(device="cpu", workers=1)


def _jdata():
    from videoprocessingframework_tpu import data

    return data


def _np(batches):
    return [b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            for b in batches]


@pytest.fixture(scope="module")
def corpus(test_mp4):
    return VideoCorpus([test_mp4])


@pytest.fixture(scope="module")
def all_frames(test_mp4):
    rd = VideoReader(test_mp4)
    rd.decoder.output_format = PixelFormat.YUV420
    out = np.stack([f.data.reshape(ROWS, W).copy() for f in rd.frames()])
    assert len(out) == NFRAMES
    return out


def _mp4(path, w, h, n, seed, gop=1):
    """An mp4 of ``n`` seeded frames (the JAX package's encoder+muxer).
    A frame-number seek past the last keyframe of such a file finds no
    packet in either package, so the loaders' files are all keyframes
    unless the test is about GOPs."""
    from videoprocessingframework_tpu.core.enums import CodecId
    from videoprocessingframework_tpu.io import StreamMuxer, VideoEncoder

    enc = VideoEncoder({"codec": "h264", "preset": "P1", "s": f"{w}x{h}",
                        "fps": "30", "gop": str(gop), "bf": "0",
                        "bitrate": "2M"})
    mux = StreamMuxer(str(path), CodecId.H264, w, h, fps=30.0, format="mp4")
    rng = np.random.default_rng(seed)
    k = 0
    for i in range(n):
        y = rng.integers(0, 256, (h, w), np.uint8)
        uv = np.full((h // 2, w), 100 + i, np.uint8)
        out = enc.encode(np.concatenate([y.ravel(), uv.ravel()]))
        if out is not None:
            mux.write(out[0], pts=k)
            k += 1
    for pkt, _ in enc.flush():
        mux.write(pkt, pts=k)
        k += 1
    mux.close()
    return str(path)


def _raw_h264(path, w, h, n):
    """A raw Annex-B stream with B-frames: no index, so libav refuses to
    seek it."""
    from videoprocessingframework_tpu.io import VideoEncoder

    enc = VideoEncoder({"codec": "h264", "preset": "P2", "s": f"{w}x{h}",
                        "fps": "30", "gop": "8", "bitrate": "2M"})
    rng = np.random.default_rng(7)
    stream = bytearray()
    for i in range(n):
        y = rng.integers(0, 256, (h, w), np.uint8)
        uv = np.full((h // 2, w), 100 + i, np.uint8)
        out = enc.encode(np.concatenate([y.ravel(), uv.ravel()]))
        if out is not None:
            stream += out[0].tobytes()
    for pkt, _ in enc.flush():
        stream += pkt.tobytes()
    path.write_bytes(bytes(stream))
    return str(path)


def test_corpus_probe_equals_jax(corpus, test_mp4):
    jc = _jdata().VideoCorpus([test_mp4])
    assert (corpus.width, corpus.height) == (jc.width, jc.height) == (W, H)
    a, b = corpus.streams[0], jc.streams[0]
    assert (a.path, a.num_frames, a.is_vfr) == (b.path, b.num_frames,
                                                b.is_vfr)
    assert [int(v) for v in corpus.majority_colorimetry()] == [
        int(v) for v in jc.majority_colorimetry()]
    assert corpus.majority_colorimetry() == (ColorSpace.BT_709,
                                             ColorRange.MPEG)


@pytest.mark.parametrize("kw", [
    dict(clip_len=8, stride=2, shuffle=True, seed=7),
    dict(clip_len=4, stride=1, hop=3, shuffle=True, seed=1),
    dict(clip_len=5, stride=3, shuffle=False),
])
def test_sampler_equals_jax(corpus, test_mp4, kw):
    s = ClipSampler(corpus, **kw)
    j = _jdata().ClipSampler(_jdata().VideoCorpus([test_mp4]), **kw)
    assert len(s) == len(j)
    for e in (0, 1, 5):
        assert np.array_equal(s.epoch(e), j.epoch(e))
    starts = [np.arange(0, NFRAMES, 7)]
    s2 = ClipSampler(corpus, 4, starts_per_file=starts, seed=3)
    j2 = _jdata().ClipSampler(_jdata().VideoCorpus([test_mp4]), 4,
                              starts_per_file=starts, seed=3)
    assert np.array_equal(s2.epoch(2), j2.epoch(2))


@pytest.mark.parametrize("epoch", [0, 1])
def test_packed_batches_and_labels_equal_jax(test_mp4, epoch):
    kw = dict(clip_len=5, frame_stride=2, batch_size=3, output="packed",
              seed=3, labels=[7, 9])
    got = list(VideoClipLoader([test_mp4, test_mp4], **CPU, **kw)
               .epoch(epoch))
    want = list(_jdata().VideoClipLoader([test_mp4, test_mp4], workers=1,
                                         **kw).epoch(epoch))
    assert len(got) == len(want) > 0
    for (x, lx), (y, ly) in zip(got, want):
        assert x.dtype == torch.uint8 and x.shape == (x.shape[0], 5, ROWS, W)
        assert np.array_equal(x.numpy(), np.asarray(y))
        assert np.array_equal(lx, ly)


def test_clip_frames_exact(corpus, all_frames):
    T, stride = 5, 3
    ld = VideoClipLoader(corpus, clip_len=T, frame_stride=stride,
                         batch_size=2, output="packed", seed=3, **CPU)
    flat = np.concatenate(_np(ld.epoch(0)))
    samples = ld.sampler.epoch(0)
    assert flat.shape == (len(samples), T, ROWS, W)
    for clip, (_, st) in zip(flat, samples):
        assert np.array_equal(clip, all_frames[st: st + T * stride: stride])


# the same compute mode on both sides: the JAX package's "auto" is its
# split-bf16 resize, the port's is float32 ("highest"). The split-bf16
# terms are summed in another order on each side: 1.9e-5 measured
@pytest.mark.parametrize("compute,ftol", [("highest", 1e-5),
                                          ("split_bf16", 5e-5)])
@pytest.mark.parametrize("output", ["normalized", "rgb_u8",
                                    "normalized_nchw"])
def test_fused_batches_equal_jax(corpus, test_mp4, output, compute, ftol):
    tol = 1 if output == "rgb_u8" else ftol
    kw = dict(clip_len=3, batch_size=2, out_size=(56, 64), output=output,
              seed=2, compute=compute, hop=16)
    got = _np(VideoClipLoader(corpus, **CPU, **kw).epoch(0))
    want = _np(_jdata().VideoClipLoader([test_mp4], workers=1, **kw)
               .epoch(0))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert np.abs(x.astype(np.float64) - y).max() <= tol


def test_fused_matches_decode_postproc(corpus, all_frames):
    ld = VideoClipLoader(corpus, clip_len=3, batch_size=2, out_size=(56, 64),
                         output="rgb_u8", shuffle=False, **CPU)
    batch = next(iter(ld.epoch(0)))
    want = decode_postproc(
        torch.from_numpy(all_frames[:6]), src_format=PixelFormat.YUV420,
        space=ColorSpace.BT_709, rng=ColorRange.MPEG, out_h=56, out_w=64,
        output="rgb_u8")
    assert torch.equal(batch.reshape(6, 56, 64, 3), want)


def test_worker_invariance(corpus):
    kw = dict(clip_len=4, batch_size=3, output="packed", seed=11,
              device="cpu")
    a = _np(VideoClipLoader(corpus, workers=1, **kw).epoch(2))
    b = _np(VideoClipLoader(corpus, workers=3, **kw).epoch(2))
    assert len(a) == len(b)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_drop_last_and_len(corpus):
    ld = VideoClipLoader(corpus, clip_len=7, batch_size=4, output="packed",
                         **CPU)
    batches = _np(ld.epoch(0))
    assert len(batches) == len(ld)
    assert sum(b.shape[0] for b in batches) == ld.clips_per_epoch
    ld2 = VideoClipLoader(corpus, clip_len=7, batch_size=4, output="packed",
                          drop_last=True, **CPU)
    batches2 = _np(ld2.epoch(0))
    assert len(batches2) == len(ld2) == ld.clips_per_epoch // 4
    assert all(b.shape[0] == 4 for b in batches2)


def test_shard_split(corpus):
    kw = dict(clip_len=8, batch_size=2, output="packed", seed=5, **CPU)
    full = VideoClipLoader(corpus, **kw)
    want = {bytes(c) for b in _np(full.epoch(0)) for c in b}
    seen = []
    for si in range(2):
        ld = VideoClipLoader(corpus, shard_index=si, shard_count=2, **kw)
        seen += [bytes(c) for b in _np(ld.epoch(0)) for c in b]
    assert len(seen) == full.clips_per_epoch
    assert len(set(seen)) == len(seen) and set(seen) == want


@pytest.mark.parametrize("augment", [None, AugmentSpec(
    crop_scale=(0.5, 1.0), hflip=0.5, brightness=0.2, saturation=0.2)])
def test_mid_epoch_resume_exact(corpus, augment):
    kw = dict(clip_len=4, batch_size=2, out_size=(24, 24), output="rgb_u8",
              seed=13, augment=augment, hop=12, **CPU)
    full = _np(VideoClipLoader(corpus, **kw).epoch(1))
    ld = VideoClipLoader(corpus, **kw)
    it = ld.epoch(1)
    got = [next(it).numpy(), next(it).numpy()]
    state = ld.state_dict()
    assert state == {"epoch": 1, "clips": 4}
    del it
    ld2 = VideoClipLoader(corpus, **kw)
    ld2.load_state_dict(state)
    rest = _np(ld2.epoch())
    assert len(got) + len(rest) == len(full)
    assert all(np.array_equal(x, y) for x, y in zip(got + rest, full))


def test_epoch_advance_via_iter(corpus):
    ld = VideoClipLoader(corpus, clip_len=8, batch_size=2, output="packed",
                         seed=1, **CPU)
    first = next(iter(ld))
    second = next(iter(ld))
    assert not torch.equal(first, second)
    ld.set_epoch(0)
    assert torch.equal(first, next(iter(ld)))


def _aug():
    return AugmentSpec(crop_scale=(0.5, 1.0), hflip=0.5, brightness=0.2,
                       saturation=0.2)


def test_augmented_batches_apply_the_counter_params(corpus, all_frames):
    """Batch i of shard k takes the params of counter (seed, epoch,
    i·shard_count + k): deterministic, and different across shards."""
    kw = dict(clip_len=2, batch_size=2, out_size=(24, 32), output="rgb_u8",
              seed=5, shuffle=False, augment=_aug(), **CPU)
    for shard in (0, 1):
        ld = VideoClipLoader(corpus, shard_index=shard, shard_count=2, **kw)
        samples = ld.sampler.epoch(3)[shard::2]
        for i, batch in enumerate(ld.epoch(3)):
            if i == 2:
                break
            starts = samples[2 * i: 2 * i + 2, 1]
            packed = np.concatenate([all_frames[s:s + 2] for s in starts])
            params = ld.pipeline.sample(2, H, W, 3, i * 2 + shard)
            want = augment_postproc(
                torch.from_numpy(packed), params=params,
                src_format=PixelFormat.YUV420, space=ColorSpace.BT_709,
                rng=ColorRange.MPEG, out_h=24, out_w=32, output="rgb_u8",
                spec=_aug(), clip_len=2)
            assert torch.equal(batch.reshape(want.shape), want)
    p0 = ld.pipeline.sample(2, H, W, 3, 0)
    p1 = ld.pipeline.sample(2, H, W, 3, 1)
    assert not all(torch.equal(p0[k], p1[k]) for k in ("x0", "cw",
                                                        "brightness"))


def test_augmented_determinism_and_epochs(corpus):
    kw = dict(clip_len=2, batch_size=2, out_size=(32, 32), output="rgb_u8",
              seed=3, shuffle=False, augment=_aug(), hop=24, **CPU)
    a = _np(VideoClipLoader(corpus, **kw).epoch(0))
    b = _np(VideoClipLoader(corpus, **kw).epoch(0))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = _np(VideoClipLoader(corpus, **kw).epoch(1))
    assert any((x != y).any() for x, y in zip(a, c))
    plain = next(iter(VideoClipLoader(
        corpus, **{**kw, "augment": None}).epoch(0)))
    assert (plain.numpy() != a[0]).any()


def test_loader_configuration_errors(corpus, test_mp4):
    with pytest.raises(ValueError, match="packed"):
        VideoClipLoader(corpus, output="packed", augment=_aug(), **CPU)
    with pytest.raises(ValueError, match="kernel='cuda'"):
        VideoClipLoader(corpus, output="rgb_u8", kernel="cuda",
                        augment=_aug(), **CPU)
    with pytest.raises(ValueError, match="split_bf16"):
        VideoClipLoader(corpus, output="rgb_u8", compute="split_bf16",
                        augment=_aug(), **CPU)
    with pytest.raises(TypeError, match="AugmentSpec"):
        VideoClipLoader(corpus, output="rgb_u8", augment={"crop": True},
                        **CPU)
    with pytest.raises(ValueError, match="labels for"):
        VideoClipLoader([test_mp4], output="packed", labels=[1, 2], **CPU)
    with pytest.raises(ValueError, match="shard_index"):
        VideoClipLoader(corpus, shard_index=2, shard_count=2, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VideoClipLoader(corpus)  # CUDA by default


def test_batches_never_alias_a_ring_slot(corpus):
    ld = VideoClipLoader(corpus, clip_len=4, batch_size=2, output="packed",
                         seed=8, **CPU)
    kept = list(ld.epoch(0))  # consumes the whole epoch: slots recycled
    spans = [(s.data_ptr(), s.data_ptr() + s.numel()) for s in ld._slots]
    want = _np(VideoClipLoader(corpus, clip_len=4, batch_size=2,
                               output="packed", seed=8, **CPU).epoch(0))
    for b, w in zip(kept, want):
        p = b.data_ptr()
        assert not any(lo <= p < hi for lo, hi in spans)
        assert np.array_equal(b.numpy(), w)  # unchanged by later batches


def test_bucketed_mixed_geometry_equals_jax(test_mp4, tmp_path):
    a = _mp4(tmp_path / "a.mp4", 96, 64, 8, seed=1)
    b = _mp4(tmp_path / "b.mp4", 64, 48, 8, seed=2)
    kw = dict(out_size=(32, 32), clip_len=2, batch_size=2, output="rgb_u8",
              labels=[0, 1, 2], seed=4, hop=3)
    ld = BucketedClipLoader([test_mp4, a, b], **CPU, **kw)
    jl = _jdata().BucketedClipLoader([test_mp4, a, b], workers=1, **kw)
    assert len(ld.loaders) == 3 and len(ld) == len(jl)
    assert np.array_equal(ld._schedule(0), jl._schedule(0))
    got, want = list(ld.epoch(0)), list(jl.epoch(0))
    assert len(got) == len(want) == len(ld)
    for (x, lx), (y, ly) in zip(got, want):
        assert x.shape[1:] == (2, 32, 32, 3)
        assert np.abs(x.numpy().astype(int) - np.asarray(y)).max() <= 1
        assert np.array_equal(lx, ly)
    assert sum(x.shape[0] for x, _ in got) == ld.clips_per_epoch
    with pytest.raises(ValueError, match="packed"):
        BucketedClipLoader([test_mp4], out_size=(32, 32), output="packed")


def test_bucketed_resume(test_mp4, tmp_path):
    a = _mp4(tmp_path / "ra.mp4", 96, 64, 10, seed=3)
    kw = dict(out_size=(32, 32), clip_len=2, batch_size=2, output="rgb_u8",
              seed=9, hop=3, **CPU)
    full = _np(BucketedClipLoader([test_mp4, a], **kw).epoch(1))
    ld = BucketedClipLoader([test_mp4, a], **kw)
    it = ld.epoch(1)
    first = [next(it).numpy() for _ in range(3)]
    state = ld.state_dict()
    assert state == {"epoch": 1, "batches": 3}
    del it
    ld2 = BucketedClipLoader([test_mp4, a], **kw)
    ld2.load_state_dict(state)
    rest = _np(ld2.epoch())
    assert len(first) + len(rest) == len(full)
    assert all(np.array_equal(x, y) for x, y in zip(first + rest, full))


def test_keyframe_aligned_sampling(tmp_path):
    p = _mp4(tmp_path / "gop8.mp4", 320, 240, 48, seed=0, gop=8)
    corpus = VideoCorpus([p])
    kf = corpus.keyframe_indices(0)
    assert kf[0] == 0 and np.all(kf % 8 == 0) and len(kf) == 6
    assert np.array_equal(kf, _jdata().VideoCorpus([p]).keyframe_indices(0))
    ld = VideoClipLoader(corpus, clip_len=4, batch_size=2, output="packed",
                         seed=2, align_keyframes=True, **CPU)
    samples = ld.sampler.epoch(0)
    assert np.all(np.isin(samples[:, 1], kf))
    rd = VideoReader(p)
    rd.decoder.output_format = PixelFormat.YUV420
    frames = np.stack([f.data.reshape(360, 320).copy() for f in rd.frames()])
    got = np.concatenate(_np(ld.epoch(0)))
    for clip, (_, st) in zip(got, samples):
        assert np.array_equal(clip, frames[st: st + 4])
    assert ld.frame_stats["replayed"] == 0


def test_unseekable_stream_is_read_forward(tmp_path):
    """A raw stream refuses the seek with UnseekableInputError; the loader
    reads forward instead, reopening for a rewind, over two epochs and a
    shuffled epoch."""
    w, h, nf = 320, 240, 32
    p = _raw_h264(tmp_path / "raw.h264", w, h, nf)
    rd = VideoReader(p)
    rd.decoder.output_format = PixelFormat.YUV420
    frames = np.stack([f.data.reshape(h * 3 // 2, w).copy()
                       for f in rd.frames()])
    assert len(frames) == nf
    ld = VideoClipLoader([p], clip_len=4, batch_size=2, output="packed",
                         shuffle=False, lengths=[nf], **CPU)
    for epoch in (0, 1):
        got = np.concatenate(_np(ld.epoch(epoch)))
        for clip, st in zip(got, ld.sampler.epoch(epoch)[:, 1]):
            assert np.array_equal(clip, frames[st: st + 4])
    assert ld.frame_stats["seeks"] >= 1  # the rewind
    ld2 = VideoClipLoader([p], clip_len=4, batch_size=2, output="packed",
                          seed=3, lengths=[nf], **CPU)
    got = np.concatenate(_np(ld2.epoch(0)))
    for clip, st in zip(got, ld2.sampler.epoch(0)[:, 1]):
        assert np.array_equal(clip, frames[st: st + 4])


def test_other_seek_failures_propagate(corpus, monkeypatch):
    """Only the typed refusal is read forward; any other error from the
    seek reaches the caller (the session's position is then unknown)."""
    from videoprocessingframework_torch.data import loader as loader_mod

    def boom(self, **kw):
        raise RuntimeError("Decoded frame doesn't have PTS, can't seek.")

    ld = VideoClipLoader(corpus, clip_len=2, batch_size=2, output="packed",
                         seed=1, **CPU)
    real = loader_mod._ClipReader

    def reader(*args):
        rd = real(*args)
        rd.reader.decode = lambda **kw: boom(rd.reader, **kw)
        return rd

    monkeypatch.setattr(loader_mod, "_ClipReader", reader)
    with pytest.raises(RuntimeError, match="PTS"):
        list(ld.epoch(0))


def test_host_clip_loader():
    kw = dict(n_streams=3, frames_per_stream=10, clip_len=4, batch_size=2,
              out_size=(16, 24), output="rgb_u8", labels=[5, 6, 7], seed=2,
              device="cpu")
    ld = HostClipLoader(48, 32, **kw)
    got = list(ld.epoch(0))
    again = list(HostClipLoader(48, 32, **kw).epoch(0))
    assert len(got) == len(ld) == 3  # 3 streams × 2 windows / 2
    samples = ld.sampler.epoch(0)
    for i, ((x, labels), (y, _)) in enumerate(zip(got, again)):
        assert torch.equal(x, y) and x.shape == (2, 4, 16, 24, 3)
        win = samples[2 * i: 2 * i + 2]
        assert np.array_equal(labels, np.array([5, 6, 7])[win[:, 0]])
        packed = np.concatenate([ld.frames[fi, st:st + 4] for fi, st in win])
        want = decode_postproc(
            torch.from_numpy(packed), src_format=PixelFormat.YUV420,
            space=ColorSpace.BT_709, rng=ColorRange.MPEG, out_h=16, out_w=24,
            output="rgb_u8")
        assert torch.equal(x.reshape(want.shape), want)


def test_host_and_clip_streams_sit_at_their_own_luma_levels(tmp_path):
    from videoprocessingframework_torch.io.encoder import make_clip

    ld = HostClipLoader(48, 32, n_streams=4, frames_per_stream=4,
                        clip_len=2, output="packed", device="cpu")
    for k, level in enumerate((40, 90, 140, 190)):
        luma = ld.frames[k, :, :32]
        assert luma.min() >= level and luma.max() <= level + 63
        assert luma.max() - luma.min() > 40  # still textured
    rd = VideoReader(str(make_clip(tmp_path / "l.h264", 64, 48, 3,
                                   level=120)))
    rd.decoder.output_format = PixelFormat.YUV420
    for f in rd.frames():
        y = f.data[: 64 * 48].astype(int)
        assert 110 <= y.mean() <= 160


@pytest.mark.cuda
def test_loader_cuda_matches_cpu():
    """The pinned ring, side-stream upload and the fused kernel on the
    card against the torch path on the CPU (the seeded-host loader: the
    card's machine has no libav)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from videoprocessingframework_torch.csrc import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(n_streams=2, frames_per_stream=12, clip_len=4, batch_size=2,
              out_size=(64, 64), seed=3, output="normalized")
    launch.reset_launches()
    got = [b.cpu() for b in HostClipLoader(240, 320, **kw).epoch(0)]
    assert launch.LAUNCHES["fused_resize_csc"] == len(got) > 0
    want = list(HostClipLoader(240, 320, device="cpu", **kw).epoch(0))
    for x, y in zip(got, want):
        assert (x - y).abs().max().item() <= 1e-4
