"""The port's demuxer, decoder and reader (io/demuxer.py, io/decoder.py)
and ``segment_shots`` against the JAX package's on ``tests/assets``:
stream properties, packets (bytes and metadata), frames and seeks
bit-equal; the port's typed refusal of a seek on an unseekable input and
its decoder reset after a seek past the end; device Surfaces (the card's
case is marked ``cuda``).

Two repairs of the port's native runtime, where the JAX package differs
on purpose: the frames decoded after a corrupt packet come out at the
default frame threading, and a frame-number seek in an mp4 whose index
calls every sample a sync sample steps back to a real keyframe.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_torch.core.enums import (
    CodecId,
    PixelFormat,
    SeekMode,
)
from videoprocessingframework_torch.core.exceptions import (
    UnseekableInputError,
)
from videoprocessingframework_torch.core.packet import SeekContext
from videoprocessingframework_torch.io.decoder import (
    VideoDecoder,
    VideoReader,
    codec_caps,
)
from videoprocessingframework_torch.io.demuxer import FFmpegDemuxer
from videoprocessingframework_torch.ops.scenecut import segment_shots

PROPS = ("width", "height", "framerate", "avg_framerate", "is_vfr",
         "timebase", "num_frames", "bit_depth", "extradata",
         "annexb_extradata")


def _jax_io():
    from videoprocessingframework_tpu.io import decoder, demuxer

    return demuxer, decoder


def _same_pkt(a, b):
    return (a.key, a.pts, a.dts, a.pos, a.bsl, a.duration) == (
        b.key, b.pts, b.dts, b.pos, b.bsl, b.duration)


def _same_frame(a, b):
    return (np.array_equal(a.data, b.data) and a.width == b.width
            and a.height == b.height and int(a.format) == int(b.format)
            and int(a.color_space) == int(b.color_space)
            and int(a.color_range) == int(b.color_range)
            and _same_pkt(a.pkt_data, b.pkt_data))


@pytest.mark.parametrize("asset", ["test.mp4", "test_res_change.h264"])
def test_demuxer_props_and_packets_bit_equal(asset, test_mp4):
    path = str(__import__("pathlib").Path(test_mp4).parent / asset)
    jdemux, _ = _jax_io()
    d, j = FFmpegDemuxer(path), jdemux.FFmpegDemuxer(path)
    for name in PROPS:
        assert getattr(d, name) == getattr(j, name), name
    for name in ("codec", "format", "color_space", "color_range"):
        assert int(getattr(d, name)) == int(getattr(j, name)), name
    mp, jp = d.muxing_params(), j.muxing_params()
    assert mp.stream_index == jp.stream_index and mp.width == jp.width
    n = 0
    while True:
        a, b = d.demux(need_sei=True), j.demux(need_sei=True)
        if a is None or b is None:
            assert a is None and b is None
            break
        assert np.array_equal(a.packet, b.packet)
        assert _same_pkt(a.pkt_data, b.pkt_data)
        assert (a.sei is None) == (b.sei is None)
        if a.sei is not None:
            assert np.array_equal(a.sei, b.sei)
        n += 1
    assert n > 0


def test_timestamp_conversions_equal(test_mp4):
    jdemux, _ = _jax_io()
    d, j = FFmpegDemuxer(test_mp4), jdemux.FFmpegDemuxer(test_mp4)
    for n in (0, 1, 17, 95):
        assert d.ts_from_frame_number(n) == j.ts_from_frame_number(n)
    for sec in (0.0, 0.5, 1.234, 3.1):
        assert d.ts_from_time(sec) == j.ts_from_time(sec)


@pytest.mark.parametrize("ctx", [dict(seek_frame=40), dict(seek_frame=0),
                                 dict(seek_tssec=1.5),
                                 dict(seek_frame=33,
                                      mode=SeekMode.EXACT_FRAME)])
def test_demuxer_seek_equal(test_mp4, ctx):
    from videoprocessingframework_tpu.core.packet import (
        SeekContext as JSeekContext,
    )

    jdemux, _ = _jax_io()
    d, j = FFmpegDemuxer(test_mp4), jdemux.FFmpegDemuxer(test_mp4)
    c = SeekContext(**ctx)
    jc = JSeekContext(**{k: (int(v) if k == "mode" else v)
                         for k, v in ctx.items()})
    a, b = d.seek(c), j.seek(jc)
    assert np.array_equal(a.packet, b.packet)
    assert _same_pkt(a.pkt_data, b.pkt_data)
    assert (c.out_frame_pts, c.out_frame_duration) == (
        jc.out_frame_pts, jc.out_frame_duration)
    # demuxing on continues from the same place
    assert np.array_equal(d.demux().packet, j.demux().packet)


def test_byte_reader_source_equals_path(test_mp4):
    with open(test_mp4, "rb") as f:
        d = FFmpegDemuxer(f)
        got = [r.packet for r in d]
    want = [r.packet for r in FFmpegDemuxer(test_mp4)]
    assert len(got) == len(want) == 96
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("fmt", [None, PixelFormat.YUV420])
@pytest.mark.parametrize("asset", ["test.mp4", "test_res_change.h264"])
def test_reader_frames_bit_equal(asset, fmt, test_mp4):
    path = str(__import__("pathlib").Path(test_mp4).parent / asset)
    _, jdec = _jax_io()
    r, j = VideoReader(path), jdec.VideoReader(path)
    if fmt is not None:
        r.decoder.output_format = fmt
        j.decoder.output_format = type(j.format)(int(fmt))
    n = 0
    for a, b in zip(r.frames(need_sei=True), j.frames(need_sei=True)):
        assert _same_frame(a, b), n
        n += 1
    assert r.decode() is None and j.decode() is None
    assert n > 0
    assert _same_pkt(r.last_packet_data(), j.last_packet_data())


@pytest.mark.parametrize("target", [0, 1, 29, 50, 95])
def test_frame_number_seek_lands_on_the_same_frame(test_mp4, target):
    from videoprocessingframework_tpu.core.packet import (
        SeekContext as JSeekContext,
    )

    _, jdec = _jax_io()
    r, j = VideoReader(test_mp4), jdec.VideoReader(test_mp4)
    for _ in range(7):  # from the middle of a GOP
        assert _same_frame(r.decode(), j.decode())
    c, jc = SeekContext(seek_frame=target), JSeekContext(seek_frame=target)
    a, b = r.decode(seek_ctx=c), j.decode(seek_ctx=jc)
    assert _same_frame(a, b)
    assert c.num_frames_decoded == jc.num_frames_decoded >= 1
    assert (c.out_frame_pts, c.out_frame_duration) == (
        jc.out_frame_pts, jc.out_frame_duration)
    assert a.pkt_data.pts == r.demuxer.ts_from_frame_number(target)
    # and on from there
    for _ in range(3):
        a, b = r.decode(), j.decode()
        assert (a is None and b is None) or _same_frame(a, b)


def test_time_seek_equal(test_mp4):
    from videoprocessingframework_tpu.core.packet import (
        SeekContext as JSeekContext,
    )

    _, jdec = _jax_io()
    r, j = VideoReader(test_mp4), jdec.VideoReader(test_mp4)
    c, jc = SeekContext(seek_tssec=2.0), JSeekContext(seek_tssec=2.0)
    assert _same_frame(r.decode(seek_ctx=c), j.decode(seek_ctx=jc))
    assert c.num_frames_decoded == jc.num_frames_decoded


def test_seek_past_the_end_resets_the_decoder(test_mp4):
    """The port resets the decoder before returning None, so nothing from
    before the seek comes out after it."""
    r = VideoReader(test_mp4)
    for _ in range(5):
        r.decode()
    assert r.decode(seek_ctx=SeekContext(seek_frame=10_000)) is None
    assert r.decode() is None
    assert r.decode(flush=True) is None


def test_unseekable_input_raises_typed_error_and_keeps_its_place(
        test_res_change):
    r = VideoReader(test_res_change)
    want = [f.data.copy() for f in VideoReader(test_res_change).frames()]
    got = [r.decode().data.copy() for _ in range(4)]
    with pytest.raises(UnseekableInputError):
        r.decode(seek_ctx=SeekContext(seek_frame=1))
    with pytest.raises(UnseekableInputError):
        r.demuxer.seek(SeekContext(seek_frame=1))
    got += [f.data.copy() for f in r.frames()]
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert issubclass(UnseekableInputError, RuntimeError)


def test_exact_frame_seek_refused_by_the_reader(test_mp4):
    r = VideoReader(test_mp4)
    with pytest.raises(RuntimeError, match="previous key frame"):
        r.decode(seek_ctx=SeekContext(seek_frame=3,
                                      mode=SeekMode.EXACT_FRAME))


def test_standalone_packet_decode_equals_reader(test_mp4):
    d = FFmpegDemuxer(test_mp4)
    r = VideoReader(codec=CodecId.H264)
    got = []
    for res in d:
        f = r.decode(packet=res.packet, packet_data=res.pkt_data)
        if f is not None:
            got.append(f)
    while (f := r.decode(flush=True)) is not None:
        got.append(f)
    want = list(VideoReader(test_mp4).frames())
    assert len(got) == len(want) == 96
    assert all(np.array_equal(a.data, b.data) for a, b in zip(got, want))
    with pytest.raises(RuntimeError, match="without a built-in demuxer"):
        r.decode()
    with pytest.raises(RuntimeError, match="without built-in demuxer"):
        r.width()


def test_codec_caps_equal():
    _, jdec = _jax_io()
    from videoprocessingframework_tpu.core.enums import CodecId as JCodecId

    for codec in (CodecId.H264, CodecId.HEVC):
        for encoder in (False, True):
            assert codec_caps(codec, encoder=encoder) == jdec.codec_caps(
                JCodecId(int(codec)), encoder=encoder)


def test_motion_vectors_equal(test_mp4):
    _, jdec = _jax_io()
    from videoprocessingframework_tpu.core.enums import CodecId as JCodecId

    d = FFmpegDemuxer(test_mp4)
    dec = VideoDecoder(CodecId.H264, threads=1, export_mvs=True)
    jd = jdec.VideoDecoder(JCodecId.H264, threads=1, export_mvs=True)
    seen = 0
    for res in d:
        a = dec.decode_packet(res.packet, res.pkt_data)
        b = jd.decode_packet(res.packet, res.pkt_data)
        assert (a is None) == (b is None)
        if a is not None:
            mv, jmv = dec.motion_vectors(), jd.motion_vectors()
            assert mv.dtype == jmv.dtype and np.array_equal(mv, jmv)
            seen += mv.size
        if seen > 1000:
            break
    assert seen > 0


def test_to_surface(test_mp4):
    f = next(VideoReader(test_mp4).frames())
    s = f.to_surface("cpu")
    assert s.is_on_device and s.format == PixelFormat.NV12
    for plane, host in zip(s.planes, f.planes()):
        assert isinstance(plane, torch.Tensor)
        assert np.array_equal(plane.numpy(), host)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            f.to_surface()  # CUDA by default


@pytest.mark.cuda
def test_decode_single_surface_cuda(test_mp4):
    from videoprocessingframework_torch.io.build import libav_missing

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if libav_missing():
        pytest.skip(f"needs the libav development files: {libav_missing()}")
    r = VideoReader(test_mp4)
    s = r.decode_single_surface()
    want = next(VideoReader(test_mp4).frames())
    assert s.planes[0].is_cuda
    assert np.array_equal(s.planes[0].cpu().numpy(), want.planes()[0])


def _two_shot_clip(path):
    """An mp4 of 24 frames panning one texture, then 24 of another."""
    from videoprocessingframework_tpu.core.enums import CodecId as JCodecId
    from videoprocessingframework_tpu.io import StreamMuxer, VideoEncoder

    w, h = 160, 96
    enc = VideoEncoder({"codec": "h264", "preset": "P1", "s": f"{w}x{h}",
                        "fps": "30", "gop": "12", "bf": "0",
                        "bitrate": "4M"})
    mux = StreamMuxer(str(path), JCodecId.H264, w, h, fps=30.0,
                      format="mp4")
    rng = np.random.default_rng(0)
    tex = [rng.integers(0, 256, (h // 8, w // 8 + 40), np.uint8)
           .repeat(8, 0).repeat(8, 1) for _ in range(2)]
    n = 0
    for i in range(48):
        t = tex[i // 24]
        y = np.ascontiguousarray(t[:, (i % 24) * 4:(i % 24) * 4 + w])
        uv = np.full((h // 2, w), 100 + 50 * (i // 24), np.uint8)
        out = enc.encode(np.concatenate([y.ravel(), uv.ravel()]))
        if out is not None:
            mux.write(out[0], pts=n)
            n += 1
    for pkt, _ in enc.flush():
        mux.write(pkt, pts=n)
        n += 1
    mux.close()
    return str(path)


def test_segment_shots_equal(test_mp4, tmp_path):
    from videoprocessingframework_tpu.ops.scenecut import (
        segment_shots as jax_segment_shots,
    )

    clip = _two_shot_clip(tmp_path / "two_shots.mp4")
    got = segment_shots(clip, batch=16, device="cpu")
    assert got == jax_segment_shots(clip, batch=16)
    assert len(got) == 2 and got[0][1] == 24 and got[-1][1] == 48
    assert segment_shots(test_mp4, max_frames=48, batch=16,
                         device="cpu") == [(0, 48)]


def _h264_packets(n, w=128, h=96):
    """``n`` zero-latency H.264 packets of a 128×96 clip (the port's
    encoder)."""
    from videoprocessingframework_torch.io.encoder import VideoEncoder

    enc = VideoEncoder({"codec": "h264", "preset": "P1", "s": f"{w}x{h}",
                        "bitrate": "500K"})
    frame = np.full((w * h * 3 // 2,), 100, np.uint8)
    return [enc.encode(frame, sync=True)[0] for _ in range(n)]


def _decode_after_a_corrupt_packet(dec, packets):
    """Feed a corrupted copy of the first packet, then the clean packets,
    then flush: (frames, errors by type)."""
    bad = packets[0].copy()
    bad[20:] = 0xA5
    errors, frames = [], []
    for i, p in enumerate([bad] + packets + [None] * (len(packets) + 2)):
        try:
            f = (dec.decode_packet(p) if i <= len(packets)
                 else dec.flush_frame())
        except RuntimeError as e:  # HwReset / BitstreamParser
            errors.append(type(e).__name__)
            continue
        if f is not None:
            frames.append(f.data)
    return frames, errors


@pytest.mark.parametrize("threads", [0, 1])
def test_corrupt_packet_keeps_the_frames_after_it(threads):
    """Six packets after a corrupted copy of the first: all six frames
    decode, at libav's default frame threading (threads=0) as with one
    thread. With frame threading libav reports the bad packet's error at
    the EOS send; the decoder drains first and raises the error once
    nothing is left, so the re-create drops no frame."""
    packets = _h264_packets(6)
    clean = VideoDecoder(CodecId.H264, threads=threads)
    want = [f.data for f in filter(None, map(clean.decode_packet, packets))]
    while (f := clean.flush_frame()) is not None:
        want.append(f.data)
    assert len(want) == 6
    got, errors = _decode_after_a_corrupt_packet(
        VideoDecoder(CodecId.H264, threads=threads), packets)
    assert len(got) == 6
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert errors == (["HwResetException"] if threads == 0
                      else ["BitstreamParserException"])


def test_corrupt_packet_drops_the_frames_in_the_jax_package():
    """The deliberate difference: the JAX package's decoder yields none
    of the six frames at threads=0."""
    from videoprocessingframework_tpu.core.enums import CodecId as JCodecId
    from videoprocessingframework_tpu.io.decoder import (
        VideoDecoder as JDecoder,
    )

    got, errors = _decode_after_a_corrupt_packet(
        JDecoder(JCodecId.H264, threads=0), _h264_packets(6))
    assert got == [] and errors == ["HwResetException"]


GOP, NF = 8, 20  # keyframes at 0, 8, 16; frames 17-19 follow the last


@pytest.fixture(scope="module", params=["metadata", "pts_only"])
def gop8_mp4(request, tmp_path_factory):
    """A GOP-8 mp4 of NF frames from the port's encoder and muxer. Written
    with the encoder's packet metadata, its index marks the keyframes;
    written with a pts only (each packet a key frame to the container)
    it has no sync-sample table, so the index calls every sample a sync
    sample."""
    from videoprocessingframework_torch.io.encoder import VideoEncoder
    from videoprocessingframework_torch.io.muxer import StreamMuxer

    path = tmp_path_factory.mktemp("gop8") / f"{request.param}.mp4"
    enc = VideoEncoder({"codec": "h264", "preset": "P1", "s": "128x96",
                        "fps": "30", "gop": str(GOP), "bf": "0",
                        "bitrate": "2M"})
    rng = np.random.default_rng(5)
    with StreamMuxer(str(path), CodecId.H264, 128, 96, fps=30.0,
                     format="mp4") as mux:
        for i in range(NF):
            y = rng.integers(0, 256, (96, 128), np.uint8)
            uv = np.full((48, 128), 100 + i, np.uint8)
            pkt, meta = enc.encode(np.concatenate([y.ravel(), uv.ravel()]),
                                   sync=True)
            if request.param == "metadata":
                mux.write(pkt, meta)
            else:
                mux.write(pkt, pts=i)
    return str(path)


def test_frame_number_seek_past_the_last_keyframe(gop8_mp4):
    """Every frame-number target, those after the last keyframe included,
    returns the frame with that number, bit-equal to a sequential read."""
    seq = list(VideoReader(gop8_mp4).frames())
    assert len(seq) == NF
    assert [i for i, f in enumerate(seq) if f.pkt_data.key] == [0, 8, 16]
    r = VideoReader(gop8_mp4)
    for target in list(range(NF)) + [NF - 1, 3, 17]:
        c = SeekContext(seek_frame=target)
        f = r.decode(seek_ctx=c)
        assert f is not None, target
        assert np.array_equal(f.data, seq[target].data), target
        assert f.pkt_data.pts == seq[target].pkt_data.pts
        assert 1 <= c.num_frames_decoded <= target % GOP + 1


def test_loader_window_past_the_last_keyframe_loads(gop8_mp4):
    """Every window of a shuffled epoch loads, the ones that start after
    the last keyframe (17, 18) included."""
    from videoprocessingframework_torch.data import VideoClipLoader

    rd = VideoReader(gop8_mp4)
    rd.decoder.output_format = PixelFormat.YUV420
    frames = np.stack([f.data.reshape(144, 128).copy() for f in rd.frames()])
    ld = VideoClipLoader([gop8_mp4], clip_len=2, batch_size=3, hop=1,
                         output="packed", seed=4, device="cpu")
    samples = ld.sampler.epoch(0)
    assert {17, 18} <= set(samples[:, 1].tolist())
    got = np.concatenate([b.numpy() for b in ld.epoch(0)])
    assert len(got) == len(samples) == NF - 1
    for clip, (_, st) in zip(got, samples):
        assert np.array_equal(clip, frames[st: st + 2]), st
