"""The port's encoder and muxer against the JAX package (mirrors
tests/test_encoder.py and tests/test_muxer.py).

Both packages drive the same libav encoder through their own builds of
the same ``encoder.cpp``, and the encoders run deterministically, so for
the same frames and options the packets are byte-equal, with equal
metadata; the decoded frames are bit-equal too. The muxed files are
byte-equal as well (same libavformat, same packets).
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_torch.core.enums import CodecId, PixelFormat
from videoprocessingframework_torch.core.exceptions import EncoderException
from videoprocessingframework_torch.core.surface import Surface
from videoprocessingframework_torch.io import FFmpegDemuxer
from videoprocessingframework_torch.io.decoder import VideoReader
from videoprocessingframework_torch.io.encoder import (
    ENCODER_OPTIONS,
    VideoEncoder,
    get_encoder_params,
)
from videoprocessingframework_torch.io.muxer import StreamMuxer

W, H = 128, 96
OPTS = {"codec": "h264", "preset": "P1", "s": f"{W}x{H}", "bitrate": "1M"}


def _jio():
    from videoprocessingframework_tpu import io as jio

    return jio


def _frame(i, w=W, h=H):
    """Deterministic NV12 frame (the JAX tests' gradient)."""
    y = (np.arange(h)[:, None] + np.arange(w)[None, :] + 3 * i) % 256
    uv = np.full((h // 2, w), 128 + (i % 8), np.uint8)
    return np.concatenate([y.astype(np.uint8).ravel(), uv.ravel()])


def _encode_all(enc, frames, **kw):
    out = [enc.encode(f, **kw) for f in frames]
    return [o for o in out if o is not None] + enc.flush()


def _same_meta(a, b):
    return (a.key, a.pts, a.dts, a.bsl, a.duration) == (
        b.key, b.pts, b.dts, b.bsl, b.duration)


def _decoded(path):
    return [f.data for f in VideoReader(str(path)).frames()]


def test_option_vocabulary_equals_jax():
    from videoprocessingframework_tpu.io.encoder import (
        ENCODER_OPTIONS as J_OPTIONS,
    )

    params = get_encoder_params()
    assert params == J_OPTIONS == ENCODER_OPTIONS and len(params) == 29
    assert params is not ENCODER_OPTIONS  # a copy


def test_invalid_option_and_missing_size():
    with pytest.raises(ValueError, match='Invalid parameter name"codecc"'):
        VideoEncoder({"codecc": "h264", "s": "320x240"})
    with pytest.raises(ValueError, match="'s'"):
        VideoEncoder({"codec": "h264"})
    with pytest.raises(ValueError, match="input format"):
        VideoEncoder({**OPTS, "fmt": "RGB"})


@pytest.mark.parametrize("sync", [False, True])
def test_packets_byte_equal_to_jax(tmp_path, sync):
    """frames sent == packets received after the flush (the delayed-output
    FIFO without sync, zero delay with it); packets and their metadata
    equal the JAX encoder's; the stream decodes to the same frames."""
    frames = [_frame(i) for i in range(12)]
    enc = VideoEncoder(OPTS)
    assert (enc.width, enc.height) == (W, H)
    assert enc.frame_size_in_bytes() == W * H * 3 // 2
    if sync:  # zero output delay
        for f in frames[:3]:
            out = VideoEncoder(OPTS).encode(f, sync=True)
            assert out is not None and out[0].nbytes == out[1].bsl > 0
    got = _encode_all(enc, frames, sync=sync)
    want = _encode_all(_jio().VideoEncoder(OPTS), frames, sync=sync)
    assert len(got) == len(want) == 12
    for (p, m), (jp, jm) in zip(got, want):
        assert np.array_equal(p, jp) and _same_meta(m, jm)
    path = tmp_path / "out.h264"
    path.write_bytes(b"".join(p.tobytes() for p, _ in got))
    jdec = [f.data for f in _jio().VideoReader(str(path)).frames()]
    dec = _decoded(path)
    assert len(dec) == 12
    assert all(np.array_equal(a, b) for a, b in zip(dec, jdec))


def test_sei_round_trip(tmp_path):
    payload = b"vpf sei payload 123"
    enc = VideoEncoder(OPTS)
    stream = bytearray()
    for i in range(5):
        out = enc.encode(_frame(i), sei=payload if i == 0 else None,
                         sync=True)
        stream += out[0].tobytes()
    jenc = _jio().VideoEncoder(OPTS)
    jstream = b"".join(
        jenc.encode(_frame(i), sei=payload if i == 0 else None,
                    sync=True)[0].tobytes() for i in range(5))
    assert bytes(stream) == jstream
    path = tmp_path / "sei.h264"
    path.write_bytes(bytes(stream))
    res = FFmpegDemuxer(str(path)).demux(need_sei=True)
    assert res.sei is not None and payload in res.sei.tobytes()


def test_reconfigure_resolution_change(tmp_path):
    """Reconfigure to a new size with reset + force_idr: both segments
    decode at their own geometry, to the JAX encoder's frames."""
    streams = []
    for mk in (VideoEncoder, _jio().VideoEncoder):
        enc = mk(OPTS)
        seg = [enc.encode(_frame(i), sync=True)[0] for i in range(6)]
        w2, h2 = W // 2, H // 2
        assert enc.reconfigure({"s": f"{w2}x{h2}"}, force_idr=True,
                               reset_encoder=True)
        assert (enc.width, enc.height) == (w2, h2)
        seg += [enc.encode(_frame(i, w2, h2), sync=True)[0]
                for i in range(6)]
        streams.append(b"".join(p.tobytes() for p in seg))
    assert streams[0] == streams[1]
    path = tmp_path / "res_change.h264"
    path.write_bytes(streams[0])
    sizes = [(f.width, f.height) for f in VideoReader(str(path)).frames()]
    assert len(sizes) == 12
    assert sizes[0] == (W, H) and sizes[-1] == (W // 2, H // 2)


def test_reconfigure_before_the_first_frame_applies_at_build():
    enc = VideoEncoder(OPTS)
    assert enc.reconfigure({"s": "64x48"})
    assert enc.frame_size_in_bytes() == 64 * 48 * 3 // 2
    assert enc.encode(_frame(0, 64, 48), sync=True) is not None
    with pytest.raises(ValueError, match="Invalid parameter"):
        enc.reconfigure({"nope": "1"})


def test_surface_and_tensor_input():
    """A host Surface, a CPU-tensor Surface and a CPU tensor (through
    numpy's array protocol) encode to the packets of the packed frame."""
    f = _frame(0)
    want = VideoEncoder(OPTS).encode(f, sync=True)[0]
    host = Surface.from_host_frame(f, PixelFormat.NV12, W, H)
    dev = host.to_device("cpu")
    for src in (host, dev, torch.from_numpy(f)):
        got = VideoEncoder(OPTS).encode(src, sync=True)[0]
        assert np.array_equal(got, want)
    enc = VideoEncoder(OPTS)
    with pytest.raises(ValueError, match="size"):
        enc.encode(Surface.make(PixelFormat.NV12, W * 2, H * 2, "cpu"))
    with pytest.raises(ValueError, match="format"):
        enc.encode(Surface.make(PixelFormat.YUV444, W, H, "cpu"))
    with pytest.raises(ValueError, match="bytes"):
        enc.encode(f[:-1])


def test_yuv420_input_and_flush_single_packet():
    opts = {**OPTS, "fmt": "YUV420"}
    enc = VideoEncoder(opts)
    assert enc.format == PixelFormat.YUV420
    n = sum(enc.encode(_frame(i)) is not None for i in range(4))
    while enc.flush_single_packet() is not None:
        n += 1
    assert n == 4
    assert enc.flush_single_packet() is None


def test_hevc_if_available():
    opts = {**OPTS, "codec": "hevc"}
    try:
        got = _encode_all(VideoEncoder(opts), [_frame(i) for i in range(3)])
    except EncoderException as e:
        pytest.skip(f"hevc encoder unavailable: {e}")
    want = _encode_all(_jio().VideoEncoder(opts),
                       [_frame(i) for i in range(3)])
    assert [p.tobytes() for p, _ in got] == [p.tobytes() for p, _ in want]


@pytest.mark.parametrize("container", ["mp4", "ts"])
def test_mux_roundtrip_equals_jax(tmp_path, container):
    """encode → mux → demux → decode, in both packages: the files are
    byte-equal and decode to the same frames."""
    from videoprocessingframework_tpu.core.enums import CodecId as JCodecId

    files = []
    for pkg, mk_enc, mk_mux, codec in (
        ("torch", VideoEncoder, StreamMuxer, CodecId.H264),
        ("jax", _jio().VideoEncoder, _jio().StreamMuxer, JCodecId.H264),
    ):
        enc = mk_enc({**OPTS, "fps": "30", "gop": "4"})
        out = tmp_path / f"{pkg}.{container}"
        with mk_mux(str(out), codec, W, H, fps=30) as mux:
            for p, m in _encode_all(enc, [_frame(i) for i in range(10)],
                                    sync=True):
                mux.write(p, m)
        files.append(out)
    assert files[0].read_bytes() == files[1].read_bytes()
    d = FFmpegDemuxer(str(files[0]))
    assert (d.width, d.height, d.codec) == (W, H, CodecId.H264)
    dec = _decoded(files[0])
    jdec = [f.data for f in _jio().VideoReader(str(files[1])).frames()]
    assert len(dec) == len(jdec) == 10
    assert all(np.array_equal(a, b) for a, b in zip(dec, jdec))


def test_muxer_pts_only_writes_and_errors(tmp_path):
    """Packets written with a pts and no metadata (each a key frame to the
    container), bytes input, and the open failure."""
    enc = VideoEncoder({**OPTS, "gop": "1"})
    out = tmp_path / "pts.ts"
    mux = StreamMuxer(out, CodecId.H264, W, H, fps=29.97)
    for k, (p, _) in enumerate(_encode_all(enc, [_frame(i) for i in range(4)],
                                           sync=True)):
        mux.write(p.tobytes(), pts=k)
    mux.close()
    mux.close()  # closing twice is harmless
    assert len(_decoded(out)) == 4
    with pytest.raises(RuntimeError, match="muxer open failed"):
        StreamMuxer(str(tmp_path / "x.nosuchformat"), CodecId.H264, W, H)
