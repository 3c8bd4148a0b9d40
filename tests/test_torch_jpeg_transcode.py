"""The port's split MJPEG → MJPEG transcode (ops/jpeg.py
JpegDeviceTranscoder, io/jpeg.py MjpegTranscoder) against the JAX
package's (mirrors tests/test_jpeg_transcode.py).

Bars: at ``compute="highest"`` (float32 on both sides) the device
transform's coefficients are ≤1 from JAX's and from the float64 golden
(decode → resize → encode), and the transcoders' packets are byte-equal
to JAX's on every ``workers`` count; at "auto" (JAX: split-bf16 resize,
the port: float32) coefficients stay ≤1 from the golden. Then quality,
resize, container and callback, ``max_frames``, a mid-stream geometry
change (raw sink rebuilds, container sink refuses without ``out_size``),
the typed errors.
"""

import numpy as np
import pytest

from videoprocessingframework_torch.io.jpeg import (
    JpegCoefDecoder,
    JpegStreamError,
    MjpegReader,
    MjpegTranscoder,
    MjpegWriter,
)
from videoprocessingframework_torch.ops import jpeg as J
from videoprocessingframework_torch.ops.resize import resize_matrix
from videoprocessingframework_tpu.io import jpeg as JI
from videoprocessingframework_tpu.ops import jpeg as JJ

W, H, N = 160, 128, 4
CPU = dict(device="cpu")


def _gradient_rgb(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy * 255 / h)[..., None] * np.array([1.0, 0.6, 0.3])
            + (xx * 255 / w)[..., None] * np.array([0.0, 0.4, 0.7])) / 2
    return np.clip(base[None] + rng.normal(0, 4, (n, h, w, 3)), 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    p = tmp_path_factory.mktemp("mjpeg") / "src.mjpeg"
    frames = _gradient_rgb(N, H, W)
    with MjpegWriter(str(p), W, H, quality=90, **CPU) as wr:
        wr.write_rgb(frames)
    return str(p), frames


def _psnr(a, b):
    err = a.astype(np.float64) - b.astype(np.float64)
    return 10 * np.log10(255.0 ** 2 / (err ** 2).mean())


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _golden_transcode(coeffs, src_qts, src_geom, dst_qts, dst_geom):
    """float64: golden_decode → per-plane resize → golden_encode."""
    planes = J.golden_decode(coeffs, src_qts, src_geom)
    (_, _), (_, _), (dh, dw), _ = dst_geom
    dims = ((dh, dw),) + (((dh + 1) // 2, (dw + 1) // 2),) * 2
    out = []
    for p, (oh, ow) in zip(planes, dims):
        ih, iw = p.shape[-2:]
        if (ih, iw) != (oh, ow):
            r = resize_matrix(ih, oh).astype(np.float64)
            c = resize_matrix(iw, ow).astype(np.float64)
            p = np.clip(np.rint(r @ p.astype(np.float64) @ c.T), 0,
                        255).astype(np.uint8)
        out.append(p)
    return J.golden_encode(tuple(out), dst_qts, dst_geom)


@pytest.mark.parametrize("out_size", [None, (64, 80)])
@pytest.mark.parametrize("compute", ["highest", "auto"])
def test_device_transcode_vs_jax_and_golden(clip, out_size, compute):
    path, _ = clip
    data = open(path, "rb").read()
    dec = JpegCoefDecoder()
    coeffs = [c[None] for c in dec.decode(data[: data.index(b"\xff\xd9")
                                                + 2])]
    info = dec.info
    kw = dict(quality=70, out_size=out_size, compute=compute)
    t = J.JpegDeviceTranscoder(info, **kw, **CPU)
    got = [c.numpy() for c in t(*coeffs)]
    ql, qc = t.quant_tables
    src_qts = [np.array(info.qt[c][:64], np.uint16) for c in range(3)]
    gold = _golden_transcode(coeffs, src_qts, t.src_geometry, (ql, qc, qc),
                             t.dst_geometry)
    want = JJ.JpegDeviceTranscoder(info, **kw)(*coeffs)
    for g, w, r in zip(got, want, gold):
        assert g.shape == np.asarray(w).shape and g.dtype == np.int16
        assert _maxdiff(g, r) <= 1
        if compute == "highest":
            assert _maxdiff(g, w) <= 1
    assert t.dst_geometry == J.encode_geometry(*(out_size or (H, W)), "420")


@pytest.mark.parametrize("workers", [1, 3])
def test_transcoder_packets_equal_jax(clip, workers):
    """Packets byte-equal to JAX's serial transcoder on every worker
    count, resizing to 64×80 at quality 88."""
    path, _ = clip
    kw = dict(quality=88, out_size=(64, 80), batch=3, compute="highest")
    got, want = [], []
    st = MjpegTranscoder(path, workers=workers, **kw, **CPU).run(
        lambda p, i: got.append((i, p)))
    JI.MjpegTranscoder(path, workers=1, **kw).run(
        lambda p, i: want.append((i, p)))
    assert st.frames == N and got == want
    assert st.out_bytes == sum(len(p) for _, p in got)


def test_transcoder_end_to_end_quality(clip, tmp_path):
    path, frames = clip
    sizes = {}
    for q in (30, 92):
        out = tmp_path / f"q{q}.mjpeg"
        with MjpegTranscoder(path, str(out), quality=q, batch=2,
                             **CPU) as t:
            st = t.run()
        assert st.frames == N and st.out_bytes == out.stat().st_size
        sizes[q] = st.out_bytes
    assert sizes[30] < sizes[92]
    got = np.concatenate([b.numpy() for b in MjpegReader(
        str(tmp_path / "q92.mjpeg"), output="rgb_u8", **CPU).batches()])
    assert got.shape == frames.shape
    assert _psnr(got, frames) > 33.0  # two lossy generations


def test_transcoder_container_callback_and_max_frames(clip, tmp_path):
    path, _ = clip
    out = tmp_path / "out.avi"
    seen = []
    with MjpegTranscoder(path, str(out), container="avi", **CPU) as t:
        st = t.run(on_packet=lambda pkt, i: seen.append((i, len(pkt))))
    assert st.frames == N == len(seen)
    assert [i for i, _ in seen] == list(range(N))
    got = list(MjpegReader(str(out), output="rgb_u8", **CPU).frames())
    assert len(got) == N
    st = MjpegTranscoder(path, None, max_frames=2, **CPU).run()
    assert st.frames == 2


@pytest.mark.parametrize("workers", [1, 3])
def test_transcoder_midstream_geometry_change(clip, tmp_path, workers):
    """A raw stream that changes resolution: the raw sink rebuilds and
    keeps going (packets equal to JAX's); a container sink without a
    fixed out_size refuses; a fixed out_size normalizes both parts."""
    path, _ = clip
    small = tmp_path / "small.mjpeg"
    with MjpegWriter(str(small), 96, 64, quality=90, **CPU) as wr:
        wr.write_rgb(_gradient_rgb(2, 64, 96, seed=9))
    mixed = tmp_path / "mixed.mjpeg"
    mixed.write_bytes(open(path, "rb").read() + small.read_bytes())
    got, want = [], []
    kw = dict(workers=workers, compute="highest")
    st = MjpegTranscoder(str(mixed), **kw, **CPU).run(
        lambda p, i: got.append(p))
    JI.MjpegTranscoder(str(mixed), **kw).run(lambda p, i: want.append(p))
    assert st.frames == N + 2 and got == want
    with pytest.raises(JpegStreamError, match="geometry"):
        MjpegTranscoder(str(mixed), str(tmp_path / "o.avi"),
                        container="avi", **kw, **CPU).run()
    norm = tmp_path / "norm.avi"
    st = MjpegTranscoder(str(mixed), str(norm), container="avi",
                         out_size=(64, 96), **kw, **CPU).run()
    assert st.frames == N + 2
    got = np.concatenate([b.numpy() for b in MjpegReader(
        str(norm), output="rgb_u8", **CPU).batches()])
    assert got.shape == (N + 2, 64, 96, 3)


def test_transcoder_errors(clip, test_mp4):
    path, _ = clip
    with pytest.raises(JpegStreamError, match="not MJPEG"):
        MjpegTranscoder(test_mp4, None, **CPU)
    with pytest.raises(ValueError, match="even"):
        MjpegTranscoder(path, None, out_size=(63, 80), **CPU)
    t = J.JpegDeviceTranscoder(JpegCoefDecoder().probe(
        open(path, "rb").read()), **CPU)
    with pytest.raises(ValueError, match="expected 3"):
        t(np.zeros((1, 4, 64), np.int16))
