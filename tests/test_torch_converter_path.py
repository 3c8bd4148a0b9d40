"""The converter path as a whole, against the JAX package: host frames →
upload → ``SurfaceConverter`` (NV12 / YUV420 → RGB_PLANAR) → zero-copy
tensor export / host download, at a small size (64×128 frames).

Per frame: ``FrameUploader`` → ``SurfaceConverter.Execute`` →
``SurfaceDownloader`` in both packages. Batched: ``DoubleBufferedUploader``
→ ``run_planes`` → ``surface_to_torch`` against the JAX package's
``DoubleBufferedUploader`` → ``run_planes``. Bytes equal within 1 code
(the JAX package's converter sums the CSC in an XLA dot), and within 1
code of the float64 golden.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.core.enums import (
    ColorRange as JCR,
    ColorSpace as JCS,
    PixelFormat as JF,
)
from videoprocessingframework_tpu.core.packet import (
    ColorspaceConversionContext as JCtx,
)
from videoprocessingframework_tpu.interop import transfer as jtransfer
from videoprocessingframework_tpu.ops.convert import (
    SurfaceConverter as JSurfaceConverter,
)
from videoprocessingframework_torch import (
    ColorRange,
    ColorSpace,
    ColorspaceConversionContext,
    PixelFormat,
    Surface,
    SurfaceConverter,
)
from videoprocessingframework_torch.core import geometry
from videoprocessingframework_torch.csrc import launch
from videoprocessingframework_torch.interop import (
    DoubleBufferedUploader,
    FrameUploader,
    SurfaceDownloader,
    surface_to_torch,
)
from videoprocessingframework_torch.ops import golden

F = PixelFormat
W, H, N = 128, 64, 4
PATHS = [(F.NV12, ColorSpace.BT_709, ColorRange.MPEG),
         (F.NV12, ColorSpace.BT_601, ColorRange.JPEG),
         (F.YUV420, ColorSpace.BT_601, ColorRange.MPEG)]
IDS = [f"{f.name}-{s.name}-{r.name}" for f, s, r in PATHS]


def _frames(fmt, n, seed):
    r = np.random.default_rng(seed)
    size = geometry.host_frame_size(fmt, W, H)
    return [r.integers(0, 256, size, np.uint8) for _ in range(n)]


def _golden(fmt, frame, space, rng):
    """(3H, W) planar RGB from the float64 golden."""
    s = Surface.from_host_frame(frame, fmt, W, H)
    rgb = (golden.nv12_to_rgb(*s.planes, space, rng) if fmt == F.NV12
           else golden.yuv420_to_rgb(*s.planes, space, rng))
    return np.moveaxis(rgb, -1, 0).reshape(3 * H, W)


def _within_one(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert d.max() <= 1, f"max {d.max()}, {int((d > 0).sum())} codes off"


@pytest.mark.parametrize("fmt,space,rng", PATHS, ids=IDS)
def test_per_frame_path_matches_jax(fmt, space, rng):
    up = FrameUploader(W, H, fmt, device="cpu")
    conv = SurfaceConverter(W, H, fmt, F.RGB_PLANAR)
    down = SurfaceDownloader(W, H, F.RGB_PLANAR)
    jf = JF(int(fmt))
    jup = jtransfer.FrameUploader(W, H, jf)
    jconv = JSurfaceConverter(W, H, jf, JF.RGB_PLANAR)
    jdown = jtransfer.SurfaceDownloader(W, H, JF.RGB_PLANAR)
    cc = ColorspaceConversionContext(space, rng)
    jcc = JCtx(JCS(int(space)), JCR(int(rng)))
    for frame in _frames(fmt, N, seed=int(fmt)):
        out = conv.Execute(up(frame), cc)
        assert out.format == F.RGB_PLANAR and out.is_on_device
        got = down(out).copy()
        assert got.shape == (3 * H * W,)
        _within_one(got, jdown(jconv.Execute(jup(frame), jcc)))
        _within_one(got.reshape(3 * H, W), _golden(fmt, frame, space, rng))


@pytest.mark.parametrize("fmt,space,rng", PATHS, ids=IDS)
def test_batched_path_matches_jax(fmt, space, rng):
    frames = _frames(fmt, 3 * N, seed=10 + int(fmt))
    batches = []
    for i in range(0, len(frames), N):
        ss = [Surface.from_host_frame(f, fmt, W, H) for f in frames[i:i + N]]
        batches.append(tuple(np.stack([s.planes[k] for s in ss])
                             for k in range(len(ss[0].planes))))
    conv = SurfaceConverter(W, H, fmt, F.RGB_PLANAR)
    jconv = JSurfaceConverter(W, H, JF(int(fmt)), JF.RGB_PLANAR)
    cc = ColorspaceConversionContext(space, rng)
    jcc = JCtx(JCS(int(space)), JCR(int(rng)))

    def run(uploader, convert):
        outs = []
        for b in batches:
            got = uploader.put(b)
            if got is not None:
                outs.append(convert(got))
        outs += [convert(got) for got in uploader.drain()]
        return outs

    launch.reset_launches()
    got = run(DoubleBufferedUploader(device="cpu", depth=2),
              lambda p: conv.run_planes(p, cc)[0])
    assert launch.LAUNCHES["csc_rgb_planar"] == 0  # CPU: plain version
    want = run(jtransfer.DoubleBufferedUploader(depth=2),
               lambda p: np.asarray(jconv.run_planes(p, jcc)[0]))
    assert len(got) == len(want) == len(batches)
    k = 0
    for g, w in zip(got, want):
        assert tuple(g.shape) == (N, 3 * H, W) and g.dtype == torch.uint8
        _within_one(g.numpy(), w)
        for i in range(N):  # zero-copy export of each frame
            s = Surface(F.RGB_PLANAR, W, H, [g[i]])
            t = surface_to_torch(s)
            assert t.data_ptr() == g[i].data_ptr()
            _within_one(t.numpy(), _golden(fmt, frames[k], space, rng))
            k += 1
