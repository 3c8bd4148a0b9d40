"""The port's transcoder against the JAX package (mirrors
tests/test_transcode.py and the mp4→mp4 case of tests/test_muxer.py).

Both transcoders decode through the native pool and encode with the same
libav encoder, so for the same source and options the re-encoded streams
are byte-equal and decode to the same frames.
"""

import numpy as np
import pytest

from videoprocessingframework_torch.core.enums import CodecId, PixelFormat
from videoprocessingframework_torch.io import (
    StreamMuxer,
    Transcoder,
    VideoEncoder,
    VideoReader,
    transcode,
    transcode_many,
)


def _jio():
    from videoprocessingframework_tpu import io as jio

    return jio


def _luma(path, n):
    r = VideoReader(str(path))
    r.decoder.output_format = PixelFormat.YUV420
    out = []
    for f in r.frames():
        out.append(f.data[: f.width * f.height].reshape(f.height, f.width))
        if len(out) >= n:
            break
    return out


def test_transcode_equals_jax_and_keeps_quality(test_mp4, gt, tmp_path):
    opts = {"preset": "P1", "bitrate": "4M", "constqp": "12"}
    stream, st = transcode(test_mp4, opts, max_frames=24)
    jstream, jst = _jio().transcode(test_mp4, opts, max_frames=24)
    assert st.frames == jst.frames == 24
    assert st.out_bytes == len(stream) > 0
    assert stream == jstream
    es = tmp_path / "re.h264"
    es.write_bytes(stream)
    got = _luma(es, 24)
    assert len(got) == 24
    # near-lossless qp keeps luma PSNR well above 40 dB
    for w, g in zip(_luma(test_mp4, 8), got):
        mse = ((w.astype(np.float64) - g.astype(np.float64)) ** 2).mean()
        assert 10 * np.log10(255.0**2 / max(mse, 1e-9)) > 40.0


def test_transcode_whole_stream_and_stats(test_mp4, gt):
    t = Transcoder(test_mp4, {"preset": "P1"}, batch_size=8)
    assert (t.width, t.height) == (gt["width"], gt["height"])
    assert t.enc_opts["s"] == f"{gt['width']}x{gt['height']}"
    assert t.enc_opts["fps"] == "30"
    packets = []
    st = t.run(lambda data, meta: packets.append((data, meta)))
    assert st.frames == gt["num_frames"] and st.fps > 0
    assert len(packets) == gt["num_frames"]
    assert st.out_bytes == sum(p.nbytes for p, _ in packets)
    assert packets[0][1].key == 1
    assert t.timer.counts["encode"] == gt["num_frames"] // 8
    assert t.pool._h is None  # the decode workers were stopped


def test_transcode_max_frames(test_mp4):
    _, st = transcode(test_mp4, {"preset": "P1"}, max_frames=10)
    assert st.frames == 10


def test_transcode_rejects_non_yuv420_fmt(test_mp4):
    with pytest.raises(ValueError, match="YUV420"):
        Transcoder(test_mp4, {"fmt": "YUV444"})


def test_transcoder_releases_the_slot_on_failure(test_mp4):
    t = Transcoder(test_mp4, {"preset": "P1"}, max_frames=8)

    def boom(data, meta):
        raise RuntimeError("sink failed")

    with pytest.raises(RuntimeError, match="sink failed"):
        t.run(boom)
    assert t.pool._h is None


def test_transcode_many_aggregate(test_mp4):
    agg = transcode_many([test_mp4] * 2, {"preset": "P1"}, max_frames=12,
                         keep_streams=True)
    assert agg.frames == 24
    assert len(agg.per_stream_fps) == 2
    assert agg.streams[0] == agg.streams[1] and len(agg.streams[0]) > 0
    assert agg.streams[0] == transcode(test_mp4, {"preset": "P1"},
                                       max_frames=12)[0]
    assert transcode_many([test_mp4], {"preset": "P1"},
                          max_frames=4).streams is None


def test_transcode_mp4_to_mp4_equals_jax(test_mp4, tmp_path):
    """mp4 in → decode → encode → mp4 out, in both packages: the files are
    byte-equal and decode to the same 24 frames."""
    from videoprocessingframework_tpu.core.enums import CodecId as JCodecId

    files = []
    for pkg, jio in (("torch", None), ("jax", _jio())):
        reader = (VideoReader if jio is None else jio.VideoReader)(test_mp4)
        w, h, fps = reader.width(), reader.height(), reader.framerate()
        enc = (VideoEncoder if jio is None else jio.VideoEncoder)(
            {"codec": "h264", "preset": "P1", "s": f"{w}x{h}",
             "bitrate": "2M", "fps": str(int(fps))})
        out = tmp_path / f"{pkg}.mp4"
        mux = (StreamMuxer if jio is None else jio.StreamMuxer)(
            str(out), CodecId.H264 if jio is None else JCodecId.H264, w, h,
            fps=fps)
        n = 0
        for i, frame in enumerate(reader.frames()):
            if i >= 24:
                break
            r = enc.encode(frame.data, sync=True)
            mux.write(r[0], r[1])
            n += 1
        mux.close()
        assert n == 24
        files.append(out)
    assert files[0].read_bytes() == files[1].read_bytes()
    back = [f.data for f in VideoReader(str(files[0])).frames()]
    jback = [f.data for f in _jio().VideoReader(str(files[1])).frames()]
    assert len(back) == len(jback) == 24
    assert all(np.array_equal(a, b) for a, b in zip(back, jback))
