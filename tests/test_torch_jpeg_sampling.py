"""4:2:2, 4:4:4, grayscale and progressive JPEG through the port's split
codec, against the JAX package (mirrors tests/test_jpeg_422.py,
test_jpeg_gray.py and test_jpeg_progressive.py).

Bars: block geometry equal; forward coefficients ≤1 from JAX's and from
``golden_encode`` (both float32 products of the same planes); entropy
bytes and decoded coefficients bit-equal; decoded planes equal to JAX's
and ≤1 code from the golden; fused ``rgb_u8`` at ``compute="highest"``
≤1 code from JAX's (gray: the three channels equal); transcoded packets
byte-equal to JAX's at ``"highest"``. Progressive (SOF2) streams from
Pillow decode to the coefficients of the same image coded baseline,
equal to JAX's decoder's.
"""

import io

import numpy as np
import pytest

from videoprocessingframework_torch.core.enums import CodecId, PixelFormat
from videoprocessingframework_torch.io import VideoDecoder
from videoprocessingframework_torch.io.jpeg import (
    JpegCoefDecoder,
    JpegCoefEncoder,
    MjpegReader,
    MjpegTranscoder,
    MjpegWriter,
)
from videoprocessingframework_torch.ops import jpeg as J
from videoprocessingframework_tpu.io import jpeg as JI
from videoprocessingframework_tpu.ops import jpeg as JJ

CPU = dict(device="cpu")
N = 3
#: (height, width) a sampling: 4:2:2 needs an even width only, gray and
#: 4:4:4 take odd sizes
SIZES = {"422": (126, 160), "444": (72, 88), "gray": (61, 77)}


def _planes(sampling, n, seed=0, smooth=False):
    h, w = SIZES[sampling]
    cw = w // 2 if sampling == "422" else w
    rng = np.random.default_rng(seed)
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w]
        y = np.clip((yy + xx) * 255 / (h + w) + rng.normal(0, 3, (n, h, w)),
                    0, 255).astype(np.uint8)
    else:
        y = rng.integers(0, 256, (n, h, w), np.uint8)
    if sampling == "gray":
        return (y,)
    c = [np.clip(128 + rng.normal(0, 20, (n, h, cw)), 0, 255).astype(
        np.uint8) for _ in range(2)]
    return (y, *c)


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _qts(enc):
    ql, qc = enc.quant_tables
    return (ql,) if enc.ncomp == 1 else (ql, qc, qc)


def _write_raw(path, sampling, quality=88, seed=4):
    """Raw MJPEG of N smooth frames through the port's split encoder."""
    h, w = SIZES[sampling]
    with MjpegWriter(str(path), w, h, quality=quality, sampling=sampling,
                     **CPU) as wr:
        wr.write_planes(*_planes(sampling, N, seed, smooth=True))
    return str(path)


@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("h,w", [(126, 160), (61, 77), (1080, 1920)])
def test_geometry_equals_jax(sampling, h, w):
    assert J.encode_geometry(h, w, sampling) == \
        JJ.encode_geometry(h, w, sampling)


@pytest.mark.parametrize("sampling", ["422", "444", "gray"])
def test_forward_vs_jax_and_golden(sampling):
    h, w = SIZES[sampling]
    planes = _planes(sampling, N)
    enc = J.JpegDeviceEncoder(h, w, quality=85, subsampled=sampling, **CPU)
    got = [c.numpy() for c in enc.encode_planes(*planes)]
    jenc = JJ.JpegDeviceEncoder(h, w, quality=85, subsampled=sampling)
    want = jenc.encode_planes(*planes)
    gold = J.golden_encode(planes, _qts(enc), enc.geometry)
    assert len(got) == enc.ncomp
    for g, j, r in zip(got, want, gold):
        assert g.dtype == np.int16
        assert _maxdiff(g, j) <= 1 and _maxdiff(g, r) <= 1


@pytest.mark.parametrize("sampling", ["422", "444", "gray"])
def test_entropy_roundtrip_bytes_and_libav(sampling):
    """The port's bytes equal JAX's for the same coefficients; its
    decoder gives them back; libav decodes them ≤1 from the golden."""
    h, w = SIZES[sampling]
    enc = J.JpegDeviceEncoder(h, w, quality=82, subsampled=sampling, **CPU)
    coeffs = [c.numpy()[0] for c in enc.encode_planes(
        *_planes(sampling, 1, seed=2))]
    jpg = JpegCoefEncoder(w, h, quant_tables=enc.quant_tables,
                          subsampled=sampling).encode(*coeffs)
    assert jpg == JI.JpegCoefEncoder(
        w, h, quant_tables=enc.quant_tables, subsampled=sampling
    ).encode(*coeffs)
    dec = JpegCoefDecoder()
    for got, want in zip(dec.decode(jpg), coeffs):
        assert np.array_equal(got, want)
    assert int(dec.info.ncomp) == enc.ncomp
    vdec = VideoDecoder(CodecId.MJPEG, threads=1)
    frames = [f for f in [vdec.decode_packet(np.frombuffer(jpg, np.uint8))]
              if f is not None]
    while (f := vdec.flush_frame()) is not None:
        frames.append(f)
    assert len(frames) == 1
    f = frames[0]
    gold = J.golden_decode(coeffs, _qts(enc), enc.geometry)
    fmt = {"422": PixelFormat.YUV422, "444": PixelFormat.YUV444,
           "gray": PixelFormat.Y}[sampling]
    assert f.format == fmt
    off = 0
    for g in gold:
        n = g.size
        assert _maxdiff(f.data[off: off + n].reshape(g.shape), g) <= 1
        off += n


@pytest.mark.parametrize("sampling", ["422", "444", "gray"])
def test_reader_vs_jax(tmp_path, sampling):
    h, w = SIZES[sampling]
    path = _write_raw(tmp_path / "c.mjpeg", sampling)
    rd = MjpegReader(path, output="planes", **CPU)
    assert (rd.height, rd.width) == (h, w)
    got = next(iter(rd.batches()))
    want = next(iter(JI.MjpegReader(path, output="planes").batches()))
    assert len(got) == len(want) == (1 if sampling == "gray" else 3)
    for g, j in zip(got, want):
        assert g.shape[0] == N and np.array_equal(g.numpy(), np.asarray(j))
    kw = dict(output="rgb_u8", out_size=(40, 56), compute="highest")
    rgb = next(iter(MjpegReader(path, **kw, **CPU).batches())).numpy()
    jrgb = np.asarray(next(iter(JI.MjpegReader(path, **kw).batches())))
    assert rgb.shape == (N, 40, 56, 3) and _maxdiff(rgb, jrgb) <= 1
    if sampling == "gray":  # neutral chroma: every channel is the luma
        assert np.array_equal(rgb[..., 0], rgb[..., 1])
        assert np.array_equal(rgb[..., 0], rgb[..., 2])


@pytest.mark.parametrize("sampling,out_size", [
    ("422", None), ("422", (64, 80)), ("gray", (61, 77)), ("gray", (40, 50)),
    ("444", (36, 44)),
])
def test_transcoder_vs_jax(tmp_path, sampling, out_size):
    src = _write_raw(tmp_path / "src.mjpeg", sampling)
    kw = dict(quality=85, out_size=out_size, batch=2, compute="highest")
    got, want = [], []
    st = MjpegTranscoder(src, **kw, **CPU).run(lambda p, i: got.append(p))
    JI.MjpegTranscoder(src, **kw).run(lambda p, i: want.append(p))
    assert st.frames == N and got == want
    dec = JpegCoefDecoder()
    dec.probe(got[0])
    h, w = out_size or SIZES[sampling]
    assert (dec.info.height, dec.info.width) == (h, w)
    assert int(dec.info.ncomp) == (1 if sampling == "gray" else 3)


def test_validation():
    h, w = SIZES["gray"]
    enc = J.JpegDeviceEncoder(h, w, subsampled="gray", **CPU)
    (y,) = _planes("gray", 1)
    with pytest.raises(ValueError, match="expected 1 planes"):
        enc.encode_planes(y, y, y)
    with pytest.raises(ValueError, match="expected 1 coefficient"):
        JpegCoefEncoder(w, h, subsampled="gray").encode(
            *(np.zeros((4, 64), np.int16),) * 3)
    with pytest.raises(ValueError, match="expected 3 planes"):
        J.JpegDeviceEncoder(128, 128, **CPU).encode_planes(y)
    with pytest.raises(ValueError, match="4:2:2"):
        J.JpegDeviceEncoder(64, 63, subsampled="422", **CPU)
    with pytest.raises(ValueError, match="4:2:0"):
        J.JpegDeviceEncoder(63, 64, **CPU)
    with pytest.raises(ValueError, match="encode_rgb"):
        J.JpegDeviceEncoder(64, 64, subsampled="444", **CPU).encode_rgb(
            np.zeros((1, 64, 64, 3), np.uint8))


def test_gray_encode_rgb_vs_jax():
    """RGB → gray coefficients (odd target size): ≤1 from JAX's (its
    encode_feed_gray resizes in split-bf16 at "auto")."""
    rgb = np.random.default_rng(3).integers(0, 256, (2, 200, 320, 3),
                                            np.uint8)
    h, w = SIZES["gray"]
    (cy,) = J.JpegDeviceEncoder(h, w, quality=90, subsampled="gray",
                                **CPU).encode_rgb(rgb)
    (jy,) = JJ.JpegDeviceEncoder(h, w, quality=90,
                                 subsampled="gray").encode_rgb(rgb)
    assert cy.shape == (2, 8 * 10, 64) and _maxdiff(cy.numpy(), jy) <= 1


# ---- progressive ------------------------------------------------------------


def _texture(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 80 * np.sin(x / 17) + 40 * np.cos(y / 11),
                    127 + 60 * np.cos(x / 23 + 1) + 50 * np.sin(y / 7),
                    127 + 70 * np.sin((x + y) / 19)], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
        np.uint8)


def _pil_pair(img, **kw):
    PIL = pytest.importorskip("PIL.Image")
    pim = PIL.fromarray(img, "L" if img.ndim == 2 else "RGB")
    base, prog = io.BytesIO(), io.BytesIO()
    pim.save(base, "JPEG", **kw)
    pim.save(prog, "JPEG", progressive=True, **kw)
    return base.getvalue(), prog.getvalue()


@pytest.mark.parametrize("name,img,kw", [
    ("420", _texture(120, 200), dict(quality=85, subsampling=2)),
    ("422", _texture(120, 200), dict(quality=85, subsampling=1)),
    ("444", _texture(120, 200), dict(quality=85, subsampling=0)),
    ("gray-odd", np.random.default_rng(1).integers(0, 256, (45, 63),
                                                   np.uint8),
     dict(quality=92)),
    ("edges-420", _texture(57, 41, seed=3), dict(quality=85, subsampling=2)),
    ("noise-q98", np.random.default_rng(2).integers(0, 256, (64, 64, 3),
                                                    np.uint8),
     dict(quality=98, subsampling=0)),
])
def test_progressive_equals_baseline_and_jax(name, img, kw):
    base, prog = _pil_pair(img, **kw)
    db, dp = JpegCoefDecoder(), JpegCoefDecoder()
    cb, cp = db.decode(base), dp.decode(prog)
    assert not db.info.progressive and dp.info.progressive
    jp = JI.JpegCoefDecoder().decode(prog)
    for b, p, j in zip(cb, cp, jp):
        assert np.array_equal(b, p) and np.array_equal(p, j)


def test_progressive_through_device_pipeline():
    _, prog = _pil_pair(_texture(64, 80, seed=6), quality=85, subsampling=2)
    dec = JpegCoefDecoder()
    coeffs = [c[None] for c in dec.decode(prog)]
    pipe = J.JpegDevicePipeline(dec.info, output="planes", **CPU)
    got = [p.numpy() for p in pipe(*coeffs)]
    want = JJ.JpegDevicePipeline(dec.info, output="planes")(*coeffs)
    qts = [np.array(dec.info.qt[c][:64], np.uint16) for c in range(3)]
    gold = J.golden_decode(coeffs, qts, pipe.geometry)
    for g, j, r in zip(got, want, gold):
        assert np.array_equal(g, np.asarray(j)) and _maxdiff(g, r) <= 1
