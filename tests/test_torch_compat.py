"""The port's ``PyNvCodec`` namespace (videoprocessingframework_torch.compat)
on the CPU: mirrors tests/test_compat.py, tests/test_compat_extended.py
and tests/test_api_surface.py, with ``gpu_id="cpu"`` where those pass 0
(an integer id is a CUDA device and raises without one). Decoded frames,
packets and converted surfaces are held to the JAX package's compat
namespace: bit-equal, converters within 1 code. The hw-reset case
asserts all six frames: the port's decoder keeps the frames after a
corrupt packet (the JAX package yields none at its default threads).
"""

import ast
import logging
import pathlib

import numpy as np
import pytest
import torch

import videoprocessingframework_torch.compat as nvc
from videoprocessingframework_torch import compat
from videoprocessingframework_torch.core.surface import Surface as CoreSurface

from _reference_surface import REFERENCE_SURFACE

CPU = "cpu"
GT_W, GT_H, GT_FRAMES, GT_FPS = 848, 464, 96, 30
ROOT = pathlib.Path(__file__).resolve().parents[1]
STUB = ROOT / "PyNvCodec" / "__init__.pyi"


def _jnvc():
    from videoprocessingframework_tpu import compat as jnvc

    return jnvc


def _arr():
    return np.ndarray(shape=(0,), dtype=np.uint8)


# ---- the API surface (test_api_surface.py) ---------------------------------


def _stub_symbols():
    """Top-level classes/functions of PyNvCodec/__init__.pyi and each
    class's public methods and attributes."""
    tree = ast.parse(STUB.read_text())
    out = {"": []}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[""].append(node.name)
        elif isinstance(node, ast.ClassDef):
            members = out.setdefault(node.name, [])
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    name = item.name
                elif isinstance(item, ast.AnnAssign):
                    name = item.target.id
                elif isinstance(item, ast.Assign):
                    name = item.targets[0].id
                else:
                    continue
                if not (name.startswith("__") or name in ("name", "value")):
                    members.append(name)
    return out


@pytest.mark.parametrize("table", ["stub", "snapshot"])
def test_every_reference_symbol_exists(table):
    symbols = _stub_symbols() if table == "stub" else REFERENCE_SURFACE
    assert len(symbols) >= (17 if table == "stub" else 25)  # not empty
    missing = []
    for cls, members in symbols.items():
        if cls == "":
            missing += [f for f in members if not hasattr(nvc, f)]
            continue
        obj = getattr(nvc, cls, None)
        if obj is None:
            missing.append(f"class {cls}")
            continue
        missing += [f"{cls}.{m}" for m in members if not hasattr(obj, m)]
    assert not missing, f"reference API symbols missing: {missing}"


def test_all_names_equal_the_jax_namespace():
    assert sorted(nvc.__all__) == sorted(_jnvc().__all__)
    assert all(hasattr(nvc, n) for n in nvc.__all__)


# ---- decoder basics (test_compat.py) ----------------------------------------


def test_decoder_metadata(test_mp4):
    dec = nvc.PyNvDecoder(test_mp4, CPU)
    assert (dec.Width(), dec.Height()) == (GT_W, GT_H)
    assert dec.ColorSpace() == nvc.ColorSpace.BT_709
    assert dec.ColorRange() == nvc.ColorRange.MPEG
    assert dec.Format() == nvc.PixelFormat.NV12
    assert dec.Framerate() == dec.AvgFramerate() == GT_FPS
    assert not dec.IsVFR()
    assert dec.Numframes() == GT_FRAMES
    assert dec.Framesize() == GT_W * GT_H * 3 // 2
    assert dec.Timebase() == _jnvc().PyNvDecoder(test_mp4, 0).Timebase()


def test_integer_gpu_id_needs_cuda(test_mp4):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    for make in (lambda: nvc.PyNvDecoder(test_mp4, 0),
                 lambda: nvc.Surface.Make(nvc.PixelFormat.Y, 16, 16, 0),
                 lambda: nvc.PyFrameUploader(16, 16, nvc.PixelFormat.Y, 0),
                 lambda: nvc.PySurfaceConverter(
                     16, 16, nvc.PixelFormat.Y, nvc.PixelFormat.RGB, 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert nvc.GetNumGpus() == torch.cuda.device_count() == 0


def test_decode_all_surfaces_equal_jax(test_mp4):
    dec = nvc.PyNvDecoder(test_mp4, CPU)
    jdec = _jnvc().PyNvDecoder(test_mp4, 0)
    n = 0
    while True:
        surf = dec.DecodeSingleSurface()
        jsurf = jdec.DecodeSingleSurface()
        assert surf.Empty() == jsurf.Empty()
        if surf.Empty():
            break
        assert (surf.Width(), surf.Height()) == (GT_W, GT_H)
        if n % 16 == 0:
            for i in range(surf.NumPlanes()):
                assert isinstance(surf.core.planes[i], torch.Tensor)
                assert np.array_equal(surf.core.planes[i].numpy(),
                                      np.asarray(jsurf.core.planes[i]))
        n += 1
    assert n == GT_FRAMES


def test_decode_all_frames_with_pkt_data(test_mp4):
    dec = nvc.PyNvDecoder(test_mp4, CPU)
    jdec = _jnvc().PyNvDecoder(test_mp4, 0)
    frame, jframe = _arr(), _arr()
    pdata, jpdata = nvc.PacketData(), _jnvc().PacketData()
    last_pts, n = None, 0
    while dec.DecodeSingleFrame(frame, pdata):
        assert jdec.DecodeSingleFrame(jframe, jpdata)
        assert np.array_equal(frame, jframe)
        assert (pdata.pts, pdata.dts, pdata.key) == (
            jpdata.pts, jpdata.dts, jpdata.key)
        assert frame.size == GT_W * GT_H * 3 // 2
        assert last_pts is None or pdata.pts > last_pts
        last_pts = pdata.pts
        n += 1
    assert n == GT_FRAMES


def test_decode_with_sei(test_mp4):
    dec = nvc.PyNvDecoder(test_mp4, CPU)
    frame, sei = _arr(), _arr()
    assert dec.DecodeSingleFrame(frame, sei)
    assert sei.size > 0


def test_seek_then_matches_continuous(test_mp4):
    target = 31
    cont = nvc.PyNvDecoder(test_mp4, CPU)
    frame_gt = _arr()
    for _ in range(target + 1):
        assert cont.DecodeSingleFrame(frame_gt)
    seek_dec = nvc.PyNvDecoder(test_mp4, CPU)
    frame = _arr()
    sc = nvc.SeekContext(seek_frame=target)
    assert seek_dec.DecodeSingleFrame(frame, sc)
    np.testing.assert_array_equal(frame, frame_gt)
    assert sc.num_frames_decoded >= 1


def test_standalone_decode_and_flush(test_mp4):
    dmx = nvc.PyFFmpegDemuxer(test_mp4)
    dec = nvc.PyNvDecoder(dmx.Width(), dmx.Height(), dmx.Format(),
                          dmx.Codec(), CPU)
    packet = _arr()
    frames = 0
    while dmx.DemuxSinglePacket(packet):
        if not dec.DecodeSurfaceFromPacket(packet).Empty():
            frames += 1
    while not dec.FlushSingleSurface().Empty():
        frames += 1
    assert frames == GT_FRAMES


def test_issue_455_contract():
    """Reference tests/test_reported_bugs.py:test_issue_455."""
    enc = nvc.PyNvEncoder({"bitrate": "30K", "fps": "10", "codec": "hevc",
                           "s": "256x256"}, CPU)
    dec = nvc.PyNvDecoder(256, 256, nvc.PixelFormat.NV12,
                          nvc.CudaVideoCodec.HEVC, CPU)
    raw = np.random.default_rng(0).integers(0, 255, 256 * 256 * 3 // 2,
                                            np.uint8)
    encoded = _arr()
    count, success = 0, False
    while success is not True and count < 10:
        success = enc.EncodeSingleFrame(raw, encoded, sync=False)
        count += 1
    assert success
    with pytest.raises(Exception) as ei:
        dec.DecodeSingleFrame(encoded)
    assert str(ei.value).startswith(
        "Tried to call DecodeSurface/DecodeFrame on a Decoder that has been "
        "initialized without a built-in demuxer.")
    dec.DecodeFrameFromPacket(_arr(), encoded)


# ---- demuxer ----------------------------------------------------------------


def test_demuxer_props_and_packets_equal_jax(test_mp4):
    dmx = nvc.PyFFmpegDemuxer(test_mp4)
    jdmx = _jnvc().PyFFmpegDemuxer(test_mp4)
    for name in ("Width", "Height", "Framerate", "AvgFramerate", "IsVFR",
                 "Timebase", "Numframes"):
        assert getattr(dmx, name)() == getattr(jdmx, name)()
    assert dmx.Codec() == nvc.CudaVideoCodec.H264
    assert int(dmx.Format()) == int(jdmx.Format())
    packet, jpacket = _arr(), _arr()
    pdata = nvc.PacketData()
    n, last_dts = 0, None
    while dmx.DemuxSinglePacket(packet):
        assert jdmx.DemuxSinglePacket(jpacket)
        assert np.array_equal(packet, jpacket)
        dmx.LastPacketData(pdata)
        assert last_dts is None or pdata.dts > last_dts
        last_dts = pdata.dts
        n += 1
    assert n == GT_FRAMES


def test_demuxer_seek(test_mp4):
    dmx = nvc.PyFFmpegDemuxer(test_mp4)
    packet = _arr()
    sc = nvc.SeekContext(seek_frame=32, mode=nvc.SeekMode.EXACT_FRAME)
    assert dmx.Seek(sc, packet)
    jpacket = _arr()
    _jnvc().PyFFmpegDemuxer(test_mp4).Seek(
        _jnvc().SeekContext(seek_frame=32, mode=_jnvc().SeekMode.EXACT_FRAME),
        jpacket)
    assert packet.size > 0 and np.array_equal(packet, jpacket)


# ---- encoder ----------------------------------------------------------------


def test_encoder_all_packets_received_equal_jax():
    W, H = 128, 96
    opts = {"codec": "h264", "preset": "P1", "s": f"{W}x{H}", "bitrate": "1M"}
    enc = nvc.PyNvEncoder(opts, CPU)
    jenc = _jnvc().PyNvEncoder(opts, 0)
    assert (enc.Width(), enc.Height()) == (W, H)
    assert enc.GetFrameSizeInBytes() == W * H * 3 // 2
    assert enc.Format() == nvc.PixelFormat.NV12
    rng = np.random.default_rng(1)
    packet, jpacket = _arr(), _arr()
    sent = received = 0
    for _ in range(12):
        frame = rng.integers(0, 255, W * H * 3 // 2, np.uint8)
        got = enc.EncodeSingleFrame(frame, packet)
        assert got == jenc.EncodeSingleFrame(frame, jpacket)
        if got:
            assert np.array_equal(packet, jpacket)
            received += 1
        sent += 1
    while enc.FlushSinglePacket(packet):
        assert jenc.FlushSinglePacket(jpacket)
        assert np.array_equal(packet, jpacket)
        received += 1
    assert received == sent
    pd = nvc.PacketData()
    enc.LastPacketData(pd)
    assert pd.pts == sent - 1


def test_encoder_reconfigure_and_redecode(tmp_path):
    W, H = 128, 96
    enc = nvc.PyNvEncoder({"codec": "h264", "preset": "P1", "s": f"{W}x{H}",
                           "bitrate": "1M"}, CPU)
    stream = _arr()
    for _ in range(5):
        enc.EncodeSingleFrame(np.full(W * H * 3 // 2, 128, np.uint8), stream,
                              sync=True, append=True)
    assert enc.Reconfigure({"s": f"{W // 2}x{H // 2}"}, force_idr=True,
                           reset_encoder=True)
    for _ in range(5):
        enc.EncodeSingleFrame(np.full(W * H * 3 // 8, 128, np.uint8), stream,
                              sync=True, append=True)
    path = tmp_path / "recfg.h264"
    path.write_bytes(stream.tobytes())
    dec = nvc.PyNvDecoder(str(path), CPU)
    out, sizes = _arr(), []
    while dec.DecodeSingleFrame(out):
        sizes.append(out.size)
    assert len(sizes) == 10
    assert sizes[0] == W * H * 3 // 2 and sizes[-1] == W * H * 3 // 8


def test_encoder_invalid_option():
    with pytest.raises(RuntimeError, match='Invalid parameter name"codecc"'):
        nvc.PyNvEncoder({"codecc": "h264", "s": "320x240"}, CPU)


def test_encoder_flush_and_format_kwarg():
    W, H = 64, 48
    enc = nvc.PyNvEncoder({"codec": "h264", "preset": "P1", "s": f"{W}x{H}"},
                          CPU, format=nvc.PixelFormat.YUV420)
    assert enc.Format() == nvc.PixelFormat.YUV420
    pkt = _arr()
    frame = np.full(W * H * 3 // 2, 90, np.uint8)
    n = sum(enc.EncodeSingleFrame(frame, pkt) for _ in range(4))
    packets = _arr()
    if n < 4:
        assert enc.Flush(packets) and packets.size > 0
    assert not enc.Flush(_arr())


def test_yuv422_encode_round_trip(tmp_path):
    W, H = 64, 48
    enc = nvc.PyNvEncoder({"codec": "h264", "preset": "P1", "s": f"{W}x{H}",
                           "fmt": "YUV422", "constqp": "1"}, CPU)
    frame = np.random.default_rng(2).integers(0, 256, W * H * 2, np.uint8)
    stream = _arr()
    for _ in range(3):
        enc.EncodeSingleFrame(frame, stream, sync=True, append=True)
    path = tmp_path / "y422.h264"
    path.write_bytes(stream.tobytes())
    dec = nvc.PyNvDecoder(str(path), CPU)
    out, n = _arr(), 0
    while dec.DecodeSingleFrame(out):
        n += 1
    assert n == 3 and dec.Format() == nvc.PixelFormat.YUV422
    assert out.size == W * H * 2


def test_encode_from_tensor_and_surface(tmp_path):
    """EncodeFromNVCVImage / EncodeFromTensor / EncodeSingleSurface from a
    tensor, a numpy array and a CPU Surface give the same packets."""
    W, H = 128, 96
    opts = {"codec": "h264", "preset": "P1", "s": f"{W}x{H}", "bitrate": "2M"}
    ys = np.arange(H, dtype=np.uint16)[:, None]
    xs = np.arange(W, dtype=np.uint16)[None, :]
    full = np.concatenate([((ys * 3 + xs) % 256).astype(np.uint8).ravel(),
                           np.full(W * H // 2, 128, np.uint8)])
    def one_packet(call, src):
        enc = nvc.PyNvEncoder(opts, CPU)
        pkt = _arr()
        assert getattr(enc, call)(src, pkt) or enc.FlushSinglePacket(pkt)
        return pkt

    want = one_packet("EncodeSingleFrame", full)
    up = nvc.PyFrameUploader(W, H, nvc.PixelFormat.NV12, CPU)
    for call, src in (
        ("EncodeFromNVCVImage", torch.from_numpy(full.reshape(-1, W))),
        ("EncodeFromNVCVImage", nvc.NVCVImage(up.UploadSingleFrame(full))),
        ("EncodeFromTensor", full),
        ("EncodeSingleSurface", up.UploadSingleFrame(full)),
    ):
        assert np.array_equal(one_packet(call, src), want), call
    enc = nvc.PyNvEncoder(opts, CPU)
    assert enc.EncodeFromNVCVImage(torch.zeros((H * 3 // 2, W),
                                               dtype=torch.uint8),
                                   _arr(), False) is False
    with pytest.raises(TypeError, match="uint8"):
        enc.EncodeFromTensor(torch.zeros(4, dtype=torch.float32), _arr())


def test_decode_surface_from_packet_nvcv_output(test_mp4, capsys):
    """NVCV-output overload: DecodeSurfaceFromPacket(pd_in, packet, pd_out,
    True) → an NVCVImage that EncodeFromNVCVImage takes and DLPack exports
    as the packed (H*3/2, W) frame."""
    dmx = nvc.PyFFmpegDemuxer(test_mp4)
    dec = nvc.PyNvDecoder(dmx.Width(), dmx.Height(), dmx.Format(),
                          dmx.Codec(), CPU)
    enc = nvc.PyNvEncoder({"preset": "P1", "codec": "h264", "profile": "high",
                           "s": f"{dmx.Width()}x{dmx.Height()}",
                           "bitrate": "10M"}, CPU)
    packet, enc_frame = _arr(), _arr()
    pd_in, pd_out = nvc.PacketData(), nvc.PacketData()
    image, encoded = None, False
    while dmx.DemuxSinglePacket(packet):
        dmx.LastPacketData(pd_in)
        img = dec.DecodeSurfaceFromPacket(pd_in, packet, pd_out, True)
        if img.width == 0 and img.height == 0:
            continue
        image = img
        if enc.EncodeFromNVCVImage(img, enc_frame):
            encoded = True
            break
    assert isinstance(image, nvc.NVCVImage)
    assert (image.width, image.height) == (dmx.Width(), dmx.Height())
    assert encoded and enc_frame.size > 0
    t = torch.from_dlpack(image)
    assert t.shape == (dmx.Height() * 3 // 2, dmx.Width())
    assert t.dtype == torch.uint8
    assert t.data_ptr() == image.packed().data_ptr()
    assert dec.DecodeSurfaceFromPacket(pd_in, packet, pd_out, False) is None
    assert "bOutputNVCVImage" in capsys.readouterr().out


# ---- surfaces, converters, transfers ----------------------------------------


def test_surface_make_clone_crop():
    s = nvc.Surface.Make(nvc.PixelFormat.NV12, 64, 48, CPU)
    assert not s.Empty() and s.NumPlanes() == 2
    assert (s.Width(), s.Height()) == (64, 48)
    assert s.HostSize() == 64 * 48 * 3 // 2 and s.OwnMemory()
    assert not s.Clone().Empty()
    cr = s.Crop(8, 8, 32, 16, 0)
    assert (cr.Width(), cr.Height()) == (32, 16)
    assert s.PlanePtr(0).ElemSize() == 1 and s.PlanePtr(0).Pitch() == 64
    assert s.Pitch(1) == 64 and s.Height(1) == 24


def test_surface_clone_gpu_id_variants():
    s = nvc.Surface.Make(nvc.PixelFormat.Y, 16, 16, CPU)
    assert not s.Clone().Empty() and not s.Clone(0).Empty()
    assert not s.Clone(12345, 67890).Empty()
    other = nvc.Surface.Make(nvc.PixelFormat.Y, 16, 16, CPU)
    other.CopyFrom(s, 0)
    assert other.HostSize() == s.HostSize()


def test_upload_download_roundtrip():
    W, H = 64, 48
    up = nvc.PyFrameUploader(W, H, nvc.PixelFormat.NV12, CPU)
    down = nvc.PySurfaceDownloader(W, H, nvc.PixelFormat.NV12, CPU)
    assert up.Format() == down.Format() == nvc.PixelFormat.NV12
    frame = np.random.default_rng(3).integers(0, 255, W * H * 3 // 2,
                                              np.uint8)
    surf = up.UploadSingleFrame(frame)
    assert not surf.Empty()
    out = _arr()
    assert down.DownloadSingleSurface(surf, out)
    np.testing.assert_array_equal(out, frame)
    assert not down.DownloadSingleSurface(
        nvc.Surface._empty(nvc.PixelFormat.NV12), out)


def test_gpumem_is_the_tensor_address_and_survives_copies():
    s = nvc.Surface.Make(nvc.PixelFormat.NV12, 64, 48, CPU)
    plane = s.PlanePtr(0)
    addr = plane.GpuMem()
    assert addr == s.core.planes[0].data_ptr()
    other = nvc.Surface.Make(nvc.PixelFormat.NV12, 64, 48, CPU)
    other.core.planes[0].fill_(7)
    s.CopyFrom(other)
    assert s.PlanePtr(0).GpuMem() == addr
    assert int(s.core.planes[0][0, 0]) == 7
    buf = nvc.PyBufferUploader(4, 16, CPU).UploadSingleBuffer(
        np.arange(64, dtype=np.uint8))
    baddr = buf.GpuMem()
    src = nvc.CudaBuffer.Make(4, 16, CPU)
    buf.CopyFrom(src)
    assert buf.GpuMem() == baddr and buf.to_numpy().max() == 0
    with pytest.raises(ValueError, match="size"):
        buf.CopyFrom(nvc.CudaBuffer.Make(4, 8, CPU))


def _cc(space=nvc.ColorSpace.BT_709, rng=nvc.ColorRange.MPEG):
    return nvc.ColorspaceConversionContext(space, rng)


def test_converter_chain_equals_jax(test_mp4):
    """NV12 → RGB → 224² → RGB_PLANAR (the SampleTorchResnet chain), each
    stage within 1 code of the JAX compat namespace's."""
    jnvc = _jnvc()
    dec = nvc.PyNvDecoder(test_mp4, CPU)
    jdec = jnvc.PyNvDecoder(test_mp4, 0)
    surf, jsurf = dec.DecodeSingleSurface(), jdec.DecodeSingleSurface()
    jcc = jnvc.ColorspaceConversionContext(jnvc.ColorSpace.BT_709,
                                           jnvc.ColorRange.MPEG)
    def gid(m):  # the CPU for the port, device 0 for the JAX package
        return CPU if m is nvc else 0

    stages = [
        (lambda m: m.PySurfaceConverter(GT_W, GT_H, m.PixelFormat.NV12,
                                        m.PixelFormat.RGB, gid(m)), True),
        (lambda m: m.PySurfaceResizer(224, 224, m.PixelFormat.RGB, gid(m)),
         False),
        (lambda m: m.PySurfaceConverter(224, 224, m.PixelFormat.RGB,
                                        m.PixelFormat.RGB_PLANAR, gid(m)),
         True),
    ]
    for make, with_cc in stages:
        conv, jconv = make(nvc), make(jnvc)
        assert int(conv.Format()) == int(jconv.Format())
        surf = conv.Execute(surf, _cc()) if with_cc else conv.Execute(surf)
        jsurf = jconv.Execute(jsurf, jcc) if with_cc else jconv.Execute(jsurf)
        assert not surf.Empty()
        a = surf.core.planes[0].numpy().astype(int)
        b = np.asarray(jsurf.core.planes[0]).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
    assert (surf.Width(), surf.PlanePtr(0).Height()) == (224, 3 * 224)


def test_converter_unsupported_returns_empty(test_mp4):
    dec = nvc.PyNvDecoder(test_mp4, CPU)
    surf = dec.DecodeSingleSurface()
    conv = nvc.PySurfaceConverter(GT_W, GT_H, nvc.PixelFormat.NV12,
                                  nvc.PixelFormat.RGB, CPU)
    # the default context (601/MPEG) is unsupported for NV12→RGB
    assert conv.Execute(surf, None).Empty()
    with pytest.raises(ValueError, match="Unsupported"):
        nvc.PySurfaceConverter(8, 8, nvc.PixelFormat.RGB_32F,
                               nvc.PixelFormat.P10, CPU)


def test_long_conversion_chain(test_mp4):
    """NV12 → Y → YUV444 → RGB → RGB_32F → RGB_32F_PLANAR."""
    dec = nvc.PyNvDecoder(test_mp4, CPU)
    w, h = dec.Width(), dec.Height()
    surf = dec.DecodeSingleSurface()
    cc = _cc(nvc.ColorSpace.BT_601, nvc.ColorRange.JPEG)
    P = nvc.PixelFormat
    for src, dst in ((P.NV12, P.Y), (P.Y, P.YUV444), (P.YUV444, P.RGB),
                     (P.RGB, P.RGB_32F), (P.RGB_32F, P.RGB_32F_PLANAR)):
        surf = nvc.PySurfaceConverter(w, h, src, dst, CPU).Execute(surf, cc)
    assert not surf.Empty() and surf.PlanePtr(0).ElemSize() == 4
    arr = surf.core.planes[0].numpy().reshape(3, h, w)
    np.testing.assert_allclose(arr[0], arr[1], atol=2 / 255)
    np.testing.assert_allclose(arr[1], arr[2], atol=2 / 255)


def test_decode_surface_then_resize_crop(test_mp4):
    dec = nvc.PyNvDecoder(test_mp4, CPU)
    rs = nvc.PySurfaceResizer(424, 232, nvc.PixelFormat.NV12, CPU)
    assert rs.Format() == nvc.PixelFormat.NV12
    crop = rs.Execute(dec.DecodeSingleSurface()).Crop(10, 10, 64, 64, 0)
    assert (crop.Width(), crop.Height()) == (64, 64)
    assert crop.Format() == nvc.PixelFormat.NV12


def test_remaper_identity():
    W, H = 32, 16
    up = nvc.PyFrameUploader(W, H, nvc.PixelFormat.RGB, CPU)
    frame = np.random.default_rng(4).integers(0, 255, W * H * 3, np.uint8)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    rm = nvc.PySurfaceRemaper(xs, ys, nvc.PixelFormat.RGB, CPU)
    assert rm.Format() == nvc.PixelFormat.RGB
    out = rm.Execute(up.UploadSingleFrame(frame))
    np.testing.assert_array_equal(out.core.download(), frame)


def test_buffer_upload_download():
    up = nvc.PyBufferUploader(4, 16, CPU)
    data = np.random.default_rng(5).integers(0, 255, 64, np.uint8)
    buf = up.UploadSingleBuffer(data)
    assert buf.GetRawMemSize() == 64
    assert (buf.GetElemSize(), buf.GetNumElems()) == (4, 16)
    out = _arr()
    assert nvc.PyCudaBufferDownloader(4, 16, CPU).DownloadSingleCudaBuffer(
        buf.Clone(), out)
    np.testing.assert_array_equal(out, data)
    with pytest.raises(ValueError, match="size"):
        up.UploadSingleBuffer(data[:8])


def test_ffmpeg_decoder_and_motion_vectors_equal_jax(test_mp4):
    dec = nvc.PyFfmpegDecoder(test_mp4, {}, CPU)
    jdec = _jnvc().PyFfmpegDecoder(test_mp4, {})
    assert (dec.Width(), dec.Height(), dec.Framerate()) == (
        jdec.Width(), jdec.Height(), jdec.Framerate())
    assert dec.Codec() == nvc.CudaVideoCodec.H264
    frame, jframe = _arr(), _arr()
    got_mvs = False
    for _ in range(6):
        assert dec.DecodeSingleFrame(frame) and jdec.DecodeSingleFrame(jframe)
        assert np.array_equal(frame, jframe)
        mv, jmv = dec.GetMotionVectors(), jdec.GetMotionVectors()
        assert mv.dtype.names == nvc.MotionVector.names
        assert np.array_equal(mv, jmv.astype(mv.dtype))
        got_mvs |= mv.size > 0
    assert got_mvs
    assert not dec.DecodeSingleSurface().Empty()


def test_get_num_gpus_and_params():
    assert nvc.GetNumGpus() == torch.cuda.device_count()
    params = nvc.GetNvencParams()
    assert "codec" in params and len(params) == 29


def test_surface_plane_import_export():
    W, H = 32, 16
    up = nvc.PyFrameUploader(W, H, nvc.PixelFormat.Y, CPU)
    frame = np.arange(W * H, dtype=np.uint8)
    plane = up.UploadSingleFrame(frame).PlanePtr(0)
    pitch = W + 16
    raw = np.zeros((H, pitch), np.uint8)
    plane.Export(raw.ctypes.data, pitch)
    np.testing.assert_array_equal(raw[:, :W].reshape(-1), frame)
    surf2 = nvc.Surface.Make(nvc.PixelFormat.Y, W, H, CPU)
    addr = surf2.PlanePtr(0).GpuMem()
    surf2.PlanePtr(0).Import(raw.ctypes.data, pitch)
    assert surf2.PlanePtr(0).GpuMem() == addr  # written in place
    out = _arr()
    assert nvc.PySurfaceDownloader(W, H, nvc.PixelFormat.Y,
                                   CPU).DownloadSingleSurface(surf2, out)
    np.testing.assert_array_equal(out, frame)


def test_motion_vector_dtype_exported():
    assert nvc.MotionVector.names[:2] == ("source", "w")
    assert nvc.MotionVector == _jnvc().MotionVector


# ---- extended (test_compat_extended.py) -------------------------------------


def test_hw_reset_recovery_loop():
    """The SampleDecode.py recovery pattern: a corrupt packet, then six
    clean ones. All six frames come out; the corrupt packet's error is
    reported once nothing is left (a typed HwResetException at the end of
    the flush), and the decoder stays usable."""
    enc = nvc.PyNvEncoder({"codec": "h264", "preset": "P1", "s": "128x96",
                           "bitrate": "500K"}, CPU)
    frame = np.full((128 * 96 * 3 // 2,), 100, np.uint8)
    packets = []
    pkt = _arr()
    for _ in range(6):
        if enc.EncodeSingleFrame(frame, pkt, sync=True):
            packets.append(pkt.copy())
    assert len(packets) == 6
    dec = nvc.PyNvDecoder(128, 96, nvc.PixelFormat.NV12,
                          nvc.CudaVideoCodec.H264, CPU)
    out = _arr()
    bad = packets[0].copy()
    bad[20:] = 0xA5
    try:
        dec.DecodeFrameFromPacket(out, bad)
    except (nvc.HwResetException, nvc.CuvidParserException, RuntimeError):
        pass
    got = sum(bool(dec.DecodeFrameFromPacket(out, p)) for p in packets)
    with pytest.raises(nvc.HwResetException):
        while dec.FlushSingleFrame(out):
            got += 1
    assert got == 6
    assert not dec.FlushSingleFrame(out)  # re-created: usable, and empty


def test_seek_by_timestamp_compat(test_mp4):
    dec = nvc.PyNvDecoder(test_mp4, CPU)
    frame = _arr()
    sc = nvc.SeekContext(seek_ts=1.5)
    assert sc.IsByTimestamp()
    assert not nvc.SeekContext(seek_frame=3).IsByTimestamp()
    assert dec.DecodeSingleFrame(frame, sc)
    assert sc.out_frame_pts > 0
    assert nvc.SeekContext(2.5).seek_tssec == 2.5  # a float is a timestamp


def test_ffmpeg_decoder_surface(test_mp4):
    dec = nvc.PyFfmpegDecoder(test_mp4, {}, CPU)
    surf = dec.DecodeSingleSurface()
    assert not surf.Empty() and surf.Width() == dec.Width()
    assert dec.Format() == nvc.PixelFormat.NV12
    assert dec.ColorSpace() == nvc.ColorSpace.BT_709
    assert dec.ColorRange() == nvc.ColorRange.MPEG


def test_real_capabilities_from_libav(test_mp4):
    opts = {"preset": "P1", "s": "320x240", "bitrate": "1M"}
    h264 = nvc.PyNvEncoder({**opts, "codec": "h264"}, CPU)
    vp8 = nvc.PyNvEncoder({**opts, "codec": "vp8"}, CPU)
    ch, cv = h264.Capabilities(), vp8.Capabilities()
    assert ch == _jnvc().PyNvEncoder({**opts, "codec": "h264"},
                                     0).Capabilities()
    assert ch != cv
    assert ch[nvc.NV_ENC_CAPS.SUPPORT_10BIT_ENCODE] == 1
    assert cv[nvc.NV_ENC_CAPS.SUPPORT_10BIT_ENCODE] == 0
    assert ch[nvc.NV_ENC_CAPS.NUM_MAX_BFRAMES] > 0
    assert cv[nvc.NV_ENC_CAPS.NUM_MAX_BFRAMES] == 0
    caps = nvc.PyNvDecoder(test_mp4, CPU).Capabilities()
    assert caps == _jnvc().PyNvDecoder(test_mp4, 0).Capabilities()
    assert caps[nvc.NV_DEC_CAPS.IS_CODEC_SUPPORTED] == 1
    assert caps[nvc.NV_DEC_CAPS.BIT_DEPTH_MINUS_8] == 0
    assert caps[nvc.NV_DEC_CAPS.MAX_WIDTH] == 8192
    assert caps[nvc.NV_DEC_CAPS.MAX_HEIGHT] == 4320


def test_caps_enums_equal_jax(test_mp4):
    jnvc = _jnvc()
    for a, b in ((nvc.NV_DEC_CAPS, jnvc.NV_DEC_CAPS),
                 (nvc.NV_ENC_CAPS, jnvc.NV_ENC_CAPS)):
        assert {m.name: m.value for m in a} == {m.name: m.value for m in b}
    caps = nvc.PyNvEncoder({"codec": "hevc", "preset": "P1", "s": "320x240",
                            "bitrate": "1M"}, CPU).Capabilities()
    assert (set(nvc.NV_ENC_CAPS) - {nvc.NV_ENC_CAPS.EXPOSED_COUNT}
            == set(caps))
    assert caps[nvc.NV_ENC_CAPS.SUPPORT_SAO] == 1
    assert caps[nvc.NV_ENC_CAPS.SUPPORTED_RATECONTROL_MODES] == 0x7
    dcaps = nvc.PyNvDecoder(test_mp4, CPU).Capabilities()
    assert set(dcaps) == set(nvc.NV_DEC_CAPS)
    assert dcaps[nvc.NV_DEC_CAPS.MAX_MB_COUNT] == (8192 // 16) * (4320 // 16)


def test_cuda_handles_warn_once(caplog):
    """The pycuda (context, stream) ctor flavor is accepted and ignored,
    with exactly one logging.warning per process; the handle never lands
    in the device index."""
    old = compat._handles_warned
    compat._handles_warned = False
    try:
        with caplog.at_level(logging.WARNING):
            nvc.PyCudaBufferDownloader(4, 16, 0x7F0012345678, 0x7F00AABBCC)
            # a second handle-flavored ctor: no second warning
            nvc.PySurfaceDownloader(64, 48, nvc.PixelFormat.YUV420,
                                    0x7F0012345678, 0x7F00AABBCC)
        warns = [r for r in caplog.records
                 if "handles were passed and are ignored" in r.getMessage()]
        assert len(warns) == 1
        assert "PyCudaBufferDownloader" in warns[0].getMessage()
        assert "TPU" not in warns[0].getMessage()
        assert compat._consume_handles("X", 0x7F00, (0x7F01,)) == 0
        assert compat._consume_handles("X", "cpu", ()) == "cpu"
    finally:
        compat._handles_warned = old


def test_cuda_array_interface_typed_error():
    surf = nvc.Surface.Make(nvc.PixelFormat.NV12, 64, 48, CPU)
    with pytest.raises(nvc.CudaArrayInterfaceUnsupported,
                       match="DLPack.*surface_to_torch"):
        surf.PlanePtr(0).__cuda_array_interface__
    with pytest.raises(nvc.CudaArrayInterfaceUnsupported, match="DLPack"):
        nvc.NVCVImage(surf).__cuda_array_interface__
    assert issubclass(nvc.CudaArrayInterfaceUnsupported, TypeError)
    # DLPack gives the plane's tensor itself
    t = torch.from_dlpack(surf.PlanePtr(0))
    assert t.data_ptr() == surf.PlanePtr(0).GpuMem()


def test_array_interface_on_host_and_tensor_planes():
    host = CoreSurface.from_host_frame(np.arange(256, dtype=np.uint8),
                                       nvc.PixelFormat.Y, 32, 8)
    plane = nvc.SurfacePlane(host.plane(0))
    view = np.asarray(plane)
    assert view.shape == (8, 32)
    assert view.__array_interface__["data"][0] == plane.GpuMem()
    dev = nvc.SurfacePlane(host.to_device("cpu").plane(0))
    with pytest.raises(nvc.CudaArrayInterfaceUnsupported):
        dev.__array_interface__


def test_nvcv_image_packing():
    y = nvc.Surface.Make(nvc.PixelFormat.YUV420, 64, 48, CPU)
    img = nvc.NVCVImage(y)
    assert img.packed().shape == (64 * 48 * 3 // 2,)  # planes of 2 widths
    assert img.format == nvc.PixelFormat.YUV420 and img.surface is y
    nv12 = nvc.NVCVImage(nvc.Surface.Make(nvc.PixelFormat.NV12, 64, 48, CPU))
    assert nv12.packed().shape == (72, 64)
    assert "64x48" in repr(nv12)


@pytest.mark.cuda
def test_compat_surface_chain_on_cuda():
    """The card's case: upload → NV12 → RGB_PLANAR (the csc_rgb_planar
    kernel) → resize → download, against the same chain on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    W, H = 128, 96
    frame = np.random.default_rng(6).integers(0, 256, W * H * 3 // 2,
                                              np.uint8)
    outs = []
    for dev in (0, CPU):
        surf = nvc.PyFrameUploader(W, H, nvc.PixelFormat.NV12,
                                   dev).UploadSingleFrame(frame)
        rgb = nvc.PySurfaceConverter(W, H, nvc.PixelFormat.NV12,
                                     nvc.PixelFormat.RGB_PLANAR,
                                     dev).Execute(surf, _cc())
        small = nvc.PySurfaceResizer(64, 48, nvc.PixelFormat.RGB_PLANAR,
                                     dev).Execute(rgb)
        out = _arr()
        assert nvc.PySurfaceDownloader(64, 48, nvc.PixelFormat.RGB_PLANAR,
                                       dev).DownloadSingleSurface(small, out)
        outs.append(out.astype(int))
    assert np.abs(outs[0] - outs[1]).max() <= 1
