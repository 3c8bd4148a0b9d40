"""The port's multi-stream decode pipeline against the JAX package
(mirrors the streams cases of tests/test_parallel.py: counts,
``max_frames``, gated and overlapped, plus serial).

Frames per stream: two 128×96 clips of different content go through both
pipelines, each through ``FusedPipeline`` (``kernel="torch"`` in the
port, the JAX pipeline at ``compute="highest"``, both full float32):
within 1 code. The serial policy is a fixed round-robin, so its batches
compare one by one; the threaded policies fill batch slots in the order
the threads finish, so their frames compare as a set. The port's raw
packed batches are bit-equal to both streams' sequential decodes (which
equal the JAX package's). The JAX pipeline's raw batches are not held:
on the CPU ``jax.device_put`` can alias the ring buffer it was given,
which the decode threads then overwrite, so its raw frames differ from a
sequential decode from run to run; its post-processed batches are
computed before the buffer is reused.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_torch.core.enums import (
    CodecId,
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.io import (
    StreamMuxer,
    VideoEncoder,
    VideoReader,
)
from videoprocessingframework_torch.ops.fused import FusedPipeline
from videoprocessingframework_torch.parallel import (
    MultiStreamPipeline,
    StreamStats,
)

W, H, N = 128, 96, 20
CPU = {"device": "cpu"}
ROWS = H * 3 // 2


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two 128×96 mp4 clips of N frames, different content each."""
    paths = []
    for k in range(2):
        p = tmp_path_factory.mktemp("streams") / f"clip{k}.mp4"
        enc = VideoEncoder({"codec": "h264", "preset": "P1", "s": f"{W}x{H}",
                            "fps": "30", "gop": "8", "bitrate": "2M"})
        rng = np.random.default_rng(k)
        tex = rng.integers(0, 256, (H // 8, W // 8 + N), np.uint8)
        with StreamMuxer(str(p), CodecId.H264, W, H, fps=30) as mux:
            for i in range(N):
                y = tex.repeat(8, 0).repeat(8, 1)[:, 8 * (i % 4):][:, :W]
                uv = np.full((H // 2, W), 60 + 80 * k + i, np.uint8)
                out = enc.encode(np.concatenate([y.ravel(), uv.ravel()]),
                                 sync=True)
                mux.write(*out)
        paths.append(str(p))
    return paths


def _sequential(path):
    return [f.data.reshape(ROWS, W) for f in VideoReader(path).frames()]


def _frames(batches):
    return [f for b in batches for f in np.asarray(b)]


def _jax_pipeline(sources, **kw):
    from videoprocessingframework_tpu.parallel.streams import (
        MultiStreamPipeline as JPipeline,
    )

    return JPipeline(sources, **kw)


def _fused(**kw):
    return FusedPipeline(PixelFormat.NV12, ColorSpace.BT_709,
                         ColorRange.MPEG, out_size=(64, 48), kernel="torch",
                         **CPU, **kw)


def test_counts_through_fused_pipeline(clips):
    pipe = MultiStreamPipeline(clips, batch_size=8, postproc=_fused(), **CPU)
    total = n_batches = 0
    for batch in pipe.batches():
        assert isinstance(batch, torch.Tensor)
        assert batch.shape[1:] == (48, 64, 3) and batch.dtype == torch.uint8
        total += batch.shape[0]
        n_batches += 1
    assert total == 2 * N
    assert pipe.stats.frames_decoded == total
    # a thread that meets its stream's end hands its slot back to the end
    # of the queue, so the last frames may fill two partial batches
    assert pipe.stats.batches == n_batches >= -(-total // 8)
    assert pipe.stats.fps > 0
    assert isinstance(pipe.stats, StreamStats)


@pytest.mark.parametrize("serial", [True, False])
def test_max_frames(clips, serial):
    pipe = MultiStreamPipeline(clips[:1], batch_size=4,
                               max_frames_per_stream=10, serial=serial, **CPU)
    batches = list(pipe.batches())
    # with no postproc each batch is the packed (B, rows, W) upload
    assert all(b.shape[1:] == (ROWS, W) for b in batches)
    assert sum(b.shape[0] for b in batches) == 10
    assert np.array_equal(np.stack(_frames(batches)),
                          np.stack(_sequential(clips[0])[:10]))


def _jfused():
    from videoprocessingframework_tpu.core.enums import (
        ColorRange as JColorRange,
        ColorSpace as JColorSpace,
        PixelFormat as JPixelFormat,
    )
    from videoprocessingframework_tpu.ops.fused import (
        FusedPipeline as JFusedPipeline,
    )

    return JFusedPipeline(JPixelFormat.NV12, JColorSpace.BT_709,
                          JColorRange.MPEG, out_size=(64, 48),
                          compute="highest")


def _maxdiff(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_serial_batches_equal_jax(clips):
    """Round-robin: stream 0, stream 1, stream 0, … in every batch, raw
    and through the fused post-processing, as in the JAX pipeline."""
    from videoprocessingframework_tpu.io import VideoReader as JReader

    kw = dict(batch_size=6, serial=True)
    got = list(MultiStreamPipeline(clips, **kw, **CPU).batches())
    assert [b.shape[0] for b in got] == [6] * 6 + [4]
    seq = [_sequential(c) for c in clips]
    for c, frames in zip(clips, seq):
        jseq = [f.data.reshape(ROWS, W) for f in JReader(c).frames()]
        assert np.array_equal(np.stack(frames), np.stack(jseq))
    assert np.array_equal(np.stack(_frames(got)[0::2]), np.stack(seq[0]))
    assert np.array_equal(np.stack(_frames(got)[1::2]), np.stack(seq[1]))

    got = list(MultiStreamPipeline(clips, postproc=_fused(), **kw,
                                   **CPU).batches())
    want = list(_jax_pipeline(clips, postproc=_jfused(), **kw).batches())
    assert [b.shape[0] for b in got] == [np.asarray(b).shape[0]
                                         for b in want]
    for g, w in zip(_frames(got), _frames(want)):
        assert _maxdiff(g, w) <= 1


@pytest.mark.parametrize("gate", [True, False], ids=["gated", "overlapped"])
def test_threaded_policies_same_frames_as_jax(clips, gate):
    """Gated (few cores) and overlapped (many cores): every frame of both
    streams once, raw; through the fused post-processing each frame
    within 1 code of one of the JAX pipeline's and the other way round."""
    kw = dict(batch_size=8, serial=False, gate_decode=gate, inflight=2)
    pipe = MultiStreamPipeline(clips, **kw, **CPU)
    assert pipe.gate_decode is gate and pipe.inflight == (1 if gate else 2)
    got = _frames(pipe.batches())
    seq = _sequential(clips[0]) + _sequential(clips[1])
    assert len(got) == 2 * N == pipe.stats.frames_decoded
    assert (sorted(f.tobytes() for f in got)
            == sorted(f.tobytes() for f in seq))

    got = _frames(MultiStreamPipeline(clips, postproc=_fused(), **kw,
                                      **CPU).batches())
    jpipe = _jax_pipeline(clips, postproc=_jfused(), **kw)
    want = _frames(jpipe.batches())
    assert len(got) == len(want) == jpipe.stats.frames_decoded == 2 * N
    for a, b in ((got, want), (want, got)):
        assert all(min(_maxdiff(f, g) for g in b) <= 1 for f in a)


def test_overlapped_with_postproc_and_loop(clips):
    """Overlapped decode through the fused post-processing, with looping
    streams capped by max_frames."""
    pipe = MultiStreamPipeline(clips, batch_size=8, postproc=_fused(),
                               max_frames_per_stream=N + 5,
                               loop_streams=True, serial=False,
                               gate_decode=False, **CPU)
    assert pipe.run().frames_decoded == 2 * (N + 5)


def test_early_close_stops_the_workers(clips):
    pipe = MultiStreamPipeline(clips, batch_size=4, serial=False,
                               gate_decode=False, loop_streams=True, **CPU)
    it = pipe.batches()
    first = next(it)
    it.close()
    assert first.shape == (4, ROWS, W)


def test_cuda_by_default(clips):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiStreamPipeline(clips)
