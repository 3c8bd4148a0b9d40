"""The port's split MJPEG decoder (io/jpeg.py, ops/jpeg.py, libvpf_jpeg)
against the JAX package's, on libav-made MJPEG (the port's VideoEncoder):

- the probe and the entropy decode are bit-equal to the JAX
  ``JpegCoefDecoder`` (and ≤1 from libav's own pixel decode through the
  float64 golden);
- the decoded planes equal JAX's (the planes path is one float32 product
  in both) and are ≤1 code from ``golden_decode``;
- fused outputs at ``compute="highest"``: ≤1 code (``rgb_u8``) / 1e-5
  (``normalized``) from JAX's; at ``"auto"`` (JAX: split-bf16, the port:
  float32) ≤2 codes / 2e-2, the looser bar of two roundings that may
  each take ±1;
- decoder reuse and copy semantics, a mid-stream geometry change, the
  typed errors, ``MjpegReader`` end to end (planes equal to JAX's) and
  through a mid-stream quant-table and geometry change.

The card's tests (marked ``cuda``) hold the pipeline and encoder on CUDA
to the CPU, and count the band kernel's launches on the 4:2:0 route.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_torch.core.enums import CodecId, PixelFormat
from videoprocessingframework_torch.io import (
    StreamMuxer,
    VideoDecoder,
    VideoEncoder,
)
from videoprocessingframework_torch.io.jpeg import (
    JpegCoefDecoder,
    JpegCoefEncoder,
    JpegStreamError,
    MjpegReader,
)
from videoprocessingframework_torch.ops import jpeg as J
from videoprocessingframework_tpu.io import jpeg as JI
from videoprocessingframework_tpu.ops import jpeg as JJ

W, H, N = 320, 240, 4
CPU = dict(device="cpu")


def _frames(n, w=W, h=H, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), np.uint8))
            for _ in range(n)]


def _encode(frames, w=W, h=H):
    """libav's MJPEG encoder through the port's VideoEncoder."""
    enc = VideoEncoder({"codec": "mjpeg", "s": f"{w}x{h}", "bitrate": "8M"},
                       device="cpu")
    pkts = []
    for y, u, v in frames:
        got = enc.encode(np.concatenate([y.ravel(), u.ravel(), v.ravel()]),
                         sync=True)
        if got is not None:
            pkts.append(got[0])
    pkts.extend(p for p, _ in enc.flush())
    return pkts


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _qts(info, n=3):
    return [np.array(info.qt[c][:64], np.uint16) for c in range(n)]


@pytest.fixture(scope="module")
def packets():
    return _encode(_frames(N))


@pytest.fixture(scope="module")
def coeffs(packets):
    dec = JpegCoefDecoder()
    return dec.decode_batch(packets), dec.info


def _libav_planes(packets):
    dec = VideoDecoder(CodecId.MJPEG, threads=1)
    frames = [f for f in (dec.decode_packet(p) for p in packets)
              if f is not None]
    while (f := dec.flush_frame()) is not None:
        frames.append(f)
    out = []
    for f in frames:
        y = f.data[: W * H].reshape(H, W)
        if f.format == PixelFormat.NV12:
            uv = f.data[W * H:].reshape(H // 2, W)
            u, v = uv[:, 0::2], uv[:, 1::2]
        else:
            c = (W // 2) * (H // 2)
            u = f.data[W * H: W * H + c].reshape(H // 2, W // 2)
            v = f.data[W * H + c:].reshape(H // 2, W // 2)
        out.append((y, u, v))
    return out


def test_probe_equals_jax(packets):
    info = JpegCoefDecoder().probe(packets[0])
    jinfo = JI.JpegCoefDecoder().probe(packets[0])
    assert (info.width, info.height, info.ncomp) == (W, H, 3)
    assert [info.hs[c] for c in range(3)] == [2, 1, 1]
    assert [info.vs[c] for c in range(3)] == [2, 1, 1]
    assert bytes(info) == bytes(jinfo)  # every field, the same layout


def test_entropy_decode_equals_jax_and_libav(packets, coeffs):
    """Bit-equal coefficients; their float64 golden is ≤1 from libav's
    own decode (its integer IDCT)."""
    (cy, cu, cv), info = coeffs
    jdec = JI.JpegCoefDecoder()
    for got, want in zip((cy, cu, cv), jdec.decode_batch(packets)):
        assert got.dtype == np.int16 and np.array_equal(got, want)
    geometry = ((int(info.bh[0]), int(info.bw[0])),
                (int(info.bh[1]), int(info.bw[1])), (H, W), True)
    gold = J.golden_decode((cy, cu, cv), _qts(info), geometry)
    for i, planes in enumerate(_libav_planes(packets)):
        for g, r in zip(gold, planes):
            assert _maxdiff(g[i], r) <= 1


def test_planes_equal_jax_and_golden(coeffs):
    (cy, cu, cv), info = coeffs
    pipe = J.JpegDevicePipeline(info, output="planes", **CPU)
    got = [p.numpy() for p in pipe(cy, cu, cv)]
    want = JJ.JpegDevicePipeline(info, output="planes", compute="highest")(
        cy, cu, cv)
    gold = J.golden_decode((cy, cu, cv), _qts(info), pipe.geometry)
    assert [g.shape for g in got] == [(N, H, W)] + [(N, H // 2, W // 2)] * 2
    for g, w, r in zip(got, want, gold):
        assert g.dtype == np.uint8
        assert np.array_equal(g, np.asarray(w))
        assert _maxdiff(g, r) <= 1
    # the pipeline's planes() is the same product
    for g, p in zip(got, pipe.planes(cy, cu, cv)):
        assert np.array_equal(g, p.numpy())


@pytest.mark.parametrize("output,compute,tol", [
    ("rgb_u8", "highest", 1), ("normalized", "highest", 1e-5),
    ("rgb_u8", "auto", 2), ("normalized", "auto", 2e-2),
])
def test_fused_outputs_vs_jax(coeffs, output, compute, tol):
    (cy, cu, cv), info = coeffs
    kw = dict(out_size=(112, 112), output=output, compute=compute)
    got = J.JpegDevicePipeline(info, **kw, **CPU)(cy, cu, cv)
    want = np.asarray(JJ.JpegDevicePipeline(info, **kw)(cy, cu, cv))
    assert got.shape == want.shape == (N, 112, 112, 3)
    assert _maxdiff(got.numpy(), want) <= tol
    # equals the two-step path: planes, then FusedPipeline
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
    )
    from videoprocessingframework_torch.ops.fused import FusedPipeline

    planes = J.JpegDevicePipeline(info, output="planes", **CPU)(cy, cu, cv)
    two = FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_601,
                        ColorRange.JPEG, (112, 112), output=output,
                        compute=compute, **CPU)(*planes)
    assert torch.equal(got, two)


def test_decoder_reuse_and_copy_semantics(packets):
    """decode() returns copies (the scratch is reused); decode_into
    writes the caller's arrays; the pipeline's output owns its memory."""
    dec = JpegCoefDecoder()
    a0 = dec.decode(packets[0])
    snap = tuple(c.copy() for c in a0)
    a1 = dec.decode(packets[1])
    for got, want in zip(a0, snap):
        assert np.array_equal(got, want)
    outs = [np.full_like(c, 7) for c in a1]
    info = dec.decode_into(packets[1], outs)
    assert (info.width, info.height) == (W, H)
    for o, c in zip(outs, a1):
        assert np.array_equal(o, c)
    batch = tuple(np.stack([c, c]) for c in a1)
    planes = J.JpegDevicePipeline(dec.info, output="planes", **CPU)(*batch)
    before = [p.clone() for p in planes]
    for c in batch:
        c[:] = 0
    for p, b in zip(planes, before):
        assert torch.equal(p, b)


def test_geometry_change_reprobe():
    """A larger image re-probes and reallocates; a smaller one fits the
    scratch and is sliced; both equal the JAX decoder's output."""
    small = _encode(_frames(1, 160, 112, seed=1), 160, 112)[0]
    big = _encode(_frames(1, 320, 240, seed=2), 320, 240)[0]
    dec, jdec = JpegCoefDecoder(), JI.JpegCoefDecoder()
    for pkt, blocks in ((small, 10 * 7 * 4), (big, 20 * 15 * 4),
                        (small, 10 * 7 * 4)):
        got, want = dec.decode(pkt), jdec.decode(pkt)
        assert got[0].shape[0] == blocks
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("data", [b"\x00\x01\x02\x03" * 10,
                                  b"\xff\xd8\xff\xdb\x00\x04\x00\x00"])
def test_unsupported_stream_raises(data):
    with pytest.raises(JpegStreamError) as got:
        JpegCoefDecoder().probe(data)
    with pytest.raises(JI.JpegStreamError) as want:
        JI.JpegCoefDecoder().probe(data)
    assert str(got.value) == str(want.value)


def _mux(path, packets, w=W, h=H):
    mux = StreamMuxer(str(path), CodecId.MJPEG, w, h, fps=30.0)
    for i, pkt in enumerate(packets):
        mux.write(pkt, pts=i)
    mux.close()
    return str(path)


def test_mjpeg_reader_equals_jax(tmp_path, packets):
    path = _mux(tmp_path / "clip.avi", packets)
    rd = MjpegReader(path, output="planes", batch=3, **CPU)
    assert (rd.width, rd.height) == (W, H)
    got = list(rd.batches())
    want = list(JI.MjpegReader(path, output="planes", batch=3).batches())
    assert [b[0].shape[0] for b in got] == [3, 1]
    for g, w in zip(got, want):
        for gp, wp in zip(g, w):
            assert np.array_equal(gp.numpy(), np.asarray(wp))
    rgb = list(MjpegReader(path, out_size=(64, 64), output="rgb_u8",
                           batch=8, **CPU).frames())
    assert len(rgb) == N and rgb[0].shape == (64, 64, 3)


def test_non_mjpeg_source_rejected(test_mp4):
    with pytest.raises(JpegStreamError, match="not MJPEG"):
        MjpegReader(test_mp4, **CPU)


def test_reader_through_table_and_geometry_changes(tmp_path):
    """A raw stream whose quant tables change at frame 2 and whose
    geometry changes at frame 4: the batches split there, the bases and
    then the pipeline are rebuilt, and every plane equals JAX's."""
    rng = np.random.default_rng(5)
    path = tmp_path / "changes.mjpeg"
    with open(path, "wb") as f:
        for q, (h, w) in ((90, (64, 96)),) * 2 + ((50, (64, 96)),) * 2 + (
                (50, (48, 80)),) * 2:
            enc = J.JpegDeviceEncoder(h, w, quality=q, **CPU)
            ce = JpegCoefEncoder(w, h, quant_tables=enc.quant_tables)
            planes = (rng.integers(0, 256, (1, h, w), np.uint8),
                      rng.integers(0, 256, (1, h // 2, w // 2), np.uint8),
                      rng.integers(0, 256, (1, h // 2, w // 2), np.uint8))
            f.write(ce.encode(*(c[0] for c in enc.encode_planes(*planes))))
    rd = MjpegReader(str(path), output="planes", batch=8, **CPU)
    got = list(rd.batches())
    want = list(JI.MjpegReader(str(path), output="planes", batch=8)
                .batches())
    assert [b[0].shape for b in got] == [(2, 64, 96)] * 2 + [(2, 48, 80)]
    assert (rd.width, rd.height) == (80, 48)
    for g, w in zip(got, want):
        for gp, wp in zip(g, w):
            assert np.array_equal(gp.numpy(), np.asarray(wp))


def test_pipeline_validation(coeffs):
    (cy, cu, cv), info = coeffs
    from videoprocessingframework_torch.ops.augment import AugmentSpec

    with pytest.raises(ValueError, match="planes"):
        J.JpegDevicePipeline(info, output="planes", augment=AugmentSpec(),
                             **CPU)
    with pytest.raises(TypeError, match="AugmentSpec"):
        J.JpegDevicePipeline(info, augment={"crop": True}, **CPU)
    with pytest.raises(ValueError, match="expected 3"):
        J.JpegDevicePipeline(info, output="planes", **CPU)(cy, cu)
    from types import SimpleNamespace

    bad = SimpleNamespace(ncomp=3, width=33, height=32, hs=[2, 1, 1],
                          vs=[2, 1, 1], bh=[4, 2, 2], bw=[6, 3, 3],
                          qt=[[1] * 64] * 3)
    with pytest.raises(ValueError, match="odd-dimension"):
        J.JpegDevicePipeline(bad, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            J.JpegDevicePipeline(info)


@pytest.mark.cuda
def test_cuda_pipeline_and_encoder_match_cpu():
    """Seeded planes → coefficients → JPEG → coefficients (no libav
    needed): the pipeline and the encoder on CUDA vs the CPU, TF32
    refused, and the 4:2:0 fused route through the band kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from videoprocessingframework_torch.csrc import launch

    (y, u, v), = _frames(1)
    planes = [np.stack([p] * N) for p in (y, u, v)]
    cpu_enc = J.JpegDeviceEncoder(H, W, quality=85, **CPU)
    host = [c.numpy() for c in cpu_enc.encode_planes(*planes)]
    enc = J.JpegDeviceEncoder(H, W, quality=85)
    for g, w in zip(enc.encode_planes(*planes), host):
        assert g.is_cuda and _maxdiff(g.cpu().numpy(), w) <= 1
    dec = JpegCoefDecoder()
    cy, cu, cv = dec.decode_batch(JpegCoefEncoder(
        W, H, quant_tables=cpu_enc.quant_tables).encode_batch(*host))
    info = dec.info
    got = J.JpegDevicePipeline(info, output="planes")(cy, cu, cv)
    want = J.JpegDevicePipeline(info, output="planes", **CPU)(cy, cu, cv)
    for g, w in zip(got, want):
        assert g.is_cuda and _maxdiff(g.cpu().numpy(), w.numpy()) <= 1
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            J.JpegDevicePipeline(info, output="planes")(cy, cu, cv)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    launch.reset_launches()
    out = J.JpegDevicePipeline(info, out_size=(112, 112), output="rgb_u8")(
        cy, cu, cv)
    assert launch.LAUNCHES["fused_resize_csc"] == 1
    ref = J.JpegDevicePipeline(info, out_size=(112, 112), output="rgb_u8",
                               **CPU)(cy, cu, cv)
    assert _maxdiff(out.cpu().numpy(), ref.numpy()) <= 1
