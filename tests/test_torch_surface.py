"""The port's memory objects and transfers against the JAX package
(mirrors tests/test_core_surface.py and tests/test_surface_interop_parity.py).

* Surface geometry, host/device round trips, HostBuffer, alloc tracking.
* torch tensors are mutable, so ``clone()`` and ``crop()`` must not alias
  their source: checked by writing in place after the copy.
* ``surface_to_torch`` is zero copy; ``FrameUploader`` /
  ``SurfaceDownloader`` / ``DoubleBufferedUploader`` round trips on
  ``device="cpu"`` and on the card (``-m cuda``), byte-equal to the JAX
  package's.
* Entry points default to CUDA and raise without a GPU.
"""

import numpy as np
import pytest
import torch

import videoprocessingframework_torch as vpt
from videoprocessingframework_tpu.core.enums import PixelFormat as JF
from videoprocessingframework_tpu.core.surface import Surface as JSurface
from videoprocessingframework_tpu.interop import transfer as jtransfer
from videoprocessingframework_torch.core import geometry
from videoprocessingframework_torch.core.enums import PixelFormat
from videoprocessingframework_torch.interop import (
    DoubleBufferedUploader,
    FrameUploader,
    SurfaceDownloader,
    surface_planes,
    surface_to_torch,
    torch_to_surface,
)
from videoprocessingframework_torch.utils import alloc

F = PixelFormat
W, H = 848, 464
#: the CPU, and the card where there is one (``-m cuda``)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
FORMATS = [F.Y, F.NV12, F.YUV420, F.YUV422, F.YUV444, F.RGB, F.BGR,
           F.RGB_PLANAR, F.RGB_32F, F.RGB_32F_PLANAR, F.P10, F.P12,
           F.YUV444_10bit]


def _frame(fmt, w=W, h=H, seed=0):
    n = geometry.host_frame_size(fmt, w, h)
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8)


@pytest.mark.parametrize("fmt", FORMATS, ids=[f.name for f in FORMATS])
def test_geometry_and_roundtrip_match_jax(fmt):
    frame = _frame(fmt, seed=int(fmt))
    s = vpt.Surface.from_host_frame(frame, fmt, W, H)
    js = JSurface.from_host_frame(frame, JF(int(fmt)), W, H)
    assert [p.shape for p in s.planes] == [p.shape for p in js.planes]
    assert [p.dtype for p in s.planes] == [p.dtype for p in js.planes]
    assert s.host_size == js.host_size == frame.nbytes
    d = s.to_device("cpu")
    assert d.is_on_device and not s.is_on_device
    assert all(p.device == torch.device("cpu") for p in d.planes)
    np.testing.assert_array_equal(d.download(), frame)
    np.testing.assert_array_equal(d.to_host().download(), frame)
    for a, b in zip(d.to_host().planes, js.planes):
        np.testing.assert_array_equal(a, b)
    p = d.plane(len(d.planes) - 1)
    jp = js.plane(len(js.planes) - 1)
    assert (p.width, p.height, p.pitch, p.elem_size, p.host_frame_size) == (
        jp.width, jp.height, jp.pitch, jp.elem_size, jp.host_frame_size)


def test_surface_make_and_repr():
    s = vpt.Surface.make(F.NV12, W, H, device="cpu")
    assert s.format == F.NV12 and s.num_planes == 2 and s.is_on_device
    assert s.download().nbytes == W * H * 3 // 2
    assert int(s.download().max()) == 0
    r = repr(s)
    assert "NV12" in r and str(W) in r and "device" in r
    assert "SurfacePlane" in repr(s.plane(0))
    assert not s.empty()


def test_surface_make_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vpt.Surface.make(F.NV12, 64, 32)
    s = vpt.Surface.from_host_frame(_frame(F.NV12, 64, 32), F.NV12, 64, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.to_device()
    for make in (lambda: FrameUploader(64, 32, F.NV12),
                 lambda: DoubleBufferedUploader(),
                 lambda: vpt.SurfaceRemaper(np.zeros((2, 2), np.float32),
                                            np.zeros((2, 2), np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("where", ["host", "device"])
def test_clone_does_not_alias(where):
    s = vpt.Surface.from_host_frame(_frame(F.RGB, 16, 8), F.RGB, 16, 8)
    if where == "device":
        s = s.to_device("cpu")
    before = s.download().copy()
    c = s.clone()
    c.planes[0][:] = 7  # write into the clone
    np.testing.assert_array_equal(s.download(), before)
    s.planes[0][:] = 9  # and into the source
    assert int(c.planes[0].max()) == 7


@pytest.mark.parametrize("where", ["host", "device"])
def test_crop_matches_jax_and_does_not_alias(where):
    frame = _frame(F.NV12, seed=1)
    s = vpt.Surface.from_host_frame(frame, F.NV12, W, H)
    if where == "device":
        s = s.to_device("cpu")
    js = JSurface.from_host_frame(frame, JF.NV12, W, H)
    c = s.crop(16, 32, 64, 48)
    jc = js.crop(16, 32, 64, 48)
    for a, b in zip(c.planes, jc.planes):
        np.testing.assert_array_equal(np.asarray(a), b)
    c.planes[0][:] = 0
    c.planes[1][:] = 0
    np.testing.assert_array_equal(s.download(), frame)
    assert all(p.is_contiguous() for p in c.planes) if where == "device" \
        else all(p.flags.c_contiguous for p in c.planes)


def test_to_device_and_to_host_copy():
    frame = _frame(F.Y, 16, 8, seed=2)
    s = vpt.Surface.from_host_frame(frame, F.Y, 16, 8)
    d = s.to_device("cpu")
    d.planes[0][:] = 0
    np.testing.assert_array_equal(s.planes[0].reshape(-1), frame)
    h = d.to_host()
    h.planes[0][:] = 5
    assert int(d.planes[0].max()) == 0
    assert d.to_device() is d  # already on a device: returned as it is


def test_plane_import_export():
    s = vpt.Surface.make(F.NV12, 32, 16, device="cpu")
    held = s.planes[0]
    data = np.arange(16 * 32, dtype=np.uint8).reshape(16, 32)
    p = s.plane(0).import_from(data)
    # device planes are written in place: every holder sees the data
    assert p.array is held and s.planes[0] is held
    np.testing.assert_array_equal(held.numpy(), data)
    out = p.export()
    out[:] = 0  # export is a copy
    np.testing.assert_array_equal(s.planes[0].numpy(), data)
    h = vpt.Surface.from_host_frame(_frame(F.NV12, 32, 16), F.NV12, 32, 16)
    h.plane(0).import_from(data)
    np.testing.assert_array_equal(h.planes[0], data)


def test_copy_from_in_place():
    src = vpt.Surface.from_host_frame(_frame(F.YUV420, 32, 16, seed=3),
                                      F.YUV420, 32, 16)
    dst = vpt.Surface.make(F.YUV420, 32, 16, device="cpu")
    held = dst.planes[1]
    dst.copy_from(src)
    assert dst.planes[1] is held
    np.testing.assert_array_equal(dst.download(), src.download())
    with pytest.raises(ValueError, match="geometry mismatch"):
        dst.copy_from(vpt.Surface.make(F.NV12, 32, 16, device="cpu"))


def test_surface_shape_validation():
    with pytest.raises(ValueError):
        vpt.Surface(F.NV12, W, H, [torch.zeros((H, W), dtype=torch.uint8)])
    with pytest.raises(ValueError, match="dtype"):
        vpt.Surface(F.Y, W, H, [torch.zeros((H, W), dtype=torch.float32)])
    with pytest.raises(ValueError):
        vpt.Surface.make(F.NV12, 99, 64, device="cpu")  # odd width


def test_host_buffer_and_alloc_tracking():
    b = vpt.HostBuffer.from_bytes(b"\x01\x02\x03")
    assert b.size() == 3
    c = vpt.HostBuffer.make(3)
    c.copy_from(b)
    np.testing.assert_array_equal(c.data, [1, 2, 3])
    with pytest.raises(ValueError, match="size mismatch"):
        c.copy_from(vpt.HostBuffer.make(4))
    alloc.reset()
    alloc.enable(True)
    try:
        s = vpt.Surface.make(F.Y, 8, 8, device="cpu")
        assert len(alloc.live_allocations()) == 1
        del s
        assert alloc.check_allocation_counters() == 0
    finally:
        alloc.enable(False)


def test_packet_and_seek_types():
    pd = vpt.PacketData(key=1, pts=100, dts=90, bsl=1234)
    assert "bsl=1234" in repr(pd)
    sc = vpt.SeekContext(seek_frame=10)
    assert sc.use_seek and sc.IsByNumber() and not sc.IsByTimestamp()
    assert vpt.SeekContext(seek_tssec=1.5).IsByTimestamp()
    assert not vpt.SeekContext().use_seek
    cc = vpt.ColorspaceConversionContext()
    assert cc.color_space == vpt.ColorSpace.UNSPEC


# ---- interop -------------------------------------------------------------------


def test_surface_to_torch_zero_copy():
    s = vpt.Surface.from_host_frame(_frame(F.NV12, 64, 32, seed=4), F.NV12,
                                    64, 32).to_device("cpu")
    t = surface_to_torch(s, 1)
    assert t is s.planes[1]
    t[:] = 3
    assert int(s.planes[1].min()) == 3
    assert surface_planes(s) == tuple(s.planes)
    host = vpt.Surface.from_host_frame(_frame(F.Y, 8, 4), F.Y, 8, 4)
    assert surface_to_torch(host).data_ptr() == \
        host.planes[0].__array_interface__["data"][0]
    assert surface_planes(host, device="cpu")[0].shape == (4, 8)


def test_torch_to_surface_views_and_copies():
    frame = torch.from_numpy(_frame(F.NV12, 64, 32, seed=5))
    s = torch_to_surface(frame, F.NV12, 64, 32)
    assert s.planes[0].data_ptr() == frame.data_ptr()  # views, no copy
    np.testing.assert_array_equal(s.download(), frame.numpy())
    c = torch_to_surface(frame, F.NV12, 64, 32, device="cpu")
    c.planes[0][:] = 0
    assert torch.equal(torch.from_numpy(s.download()), frame)
    rgbf = torch.rand(2, 3 * 4, dtype=torch.float32)
    sf = torch_to_surface(rgbf, F.RGB_32F, 4, 2)
    assert torch.equal(sf.planes[0], rgbf)


@pytest.mark.parametrize("fmt", [F.NV12, F.YUV420, F.P10, F.RGB_32F],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("device", DEVICES)
def test_uploader_downloader_roundtrip_matches_jax(fmt, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    w, h = 64, 32
    up = FrameUploader(w, h, fmt, device=device)
    down = SurfaceDownloader(w, h, fmt)
    jup = jtransfer.FrameUploader(w, h, JF(int(fmt)))
    jdown = jtransfer.SurfaceDownloader(w, h, JF(int(fmt)))
    for seed in range(3):
        frame = _frame(fmt, w, h, seed=seed)
        s = up.upload(frame)
        assert s.is_on_device and s.format == fmt
        assert s.planes[0].device.type == device
        frame_before = frame.copy()
        s.planes[0].view(-1)[:4] = 0  # the upload copied the frame
        np.testing.assert_array_equal(frame, frame_before)
        s = up(frame)
        got = down.download(s)
        want = jdown.download(jup.upload(frame))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, frame)
        out = np.zeros_like(frame)
        assert down(s, out) is out
        np.testing.assert_array_equal(out, frame)


def test_downloader_checks_size():
    down = SurfaceDownloader(64, 32, F.NV12)
    with pytest.raises(ValueError, match="downloader expects"):
        down.download(vpt.Surface.make(F.Y, 64, 32, device="cpu"))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_double_buffered_uploader_order(depth, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = np.random.default_rng(depth)
    batches = [(r.integers(0, 256, (2, 8, 16), np.uint8),
                {"uv": r.integers(0, 256, (2, 4, 16), np.uint8)})
               for _ in range(5)]
    up = DoubleBufferedUploader(device=device, depth=depth)
    jup = jtransfer.DoubleBufferedUploader(depth=depth)
    got, want = [], []
    for i, b in enumerate(batches):
        out = up.put(b)
        assert (out is None) == (i < depth)  # the pipeline fills first
        if out is not None:
            got.append(out)
        jout = jup.put(b)
        if jout is not None:
            want.append(jout)
    got += list(up.drain())
    want += list(jup.drain())
    assert len(got) == len(want) == len(batches)
    for g, w, b in zip(got, want, batches):
        assert isinstance(g, tuple) and isinstance(g[1], dict)
        assert g[0].dtype == torch.uint8 and g[0].device.type == device
        np.testing.assert_array_equal(g[0].cpu().numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(g[1]["uv"].cpu().numpy(), b[1]["uv"])
        g[0][:] = 0  # a copy: the host batch is left alone
        assert b[0].any()
