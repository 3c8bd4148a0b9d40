"""The port's analysis samples (videoprocessingframework_torch/samples:
sample_scenecut, sample_stabilize, sample_flow_interp,
sample_measure_video_quality, sample_mjpeg_transcode) on the CPU.

Each test of tests/test_samples.py for these samples has a counterpart
here that runs the port's sample with ``--device cpu`` and the same
arguments, in a subprocess, and asserts the same printed line. Then the
results against the JAX package on the same input:

* sample_scenecut: the same shot spans as the JAX sample prints;
* sample_stabilize, sample_flow_interp: ``run`` against the JAX ops on
  the same decoded frames (the JAX samples are ``slow``), the printed
  numbers within ``FLOW_TOL`` px and ``PSNR_TOL`` dB;
* sample_measure_video_quality: the originals bit-equal to the JAX
  package's decode, and on the port's round trip PSNR within
  ``PSNR_TOL`` dB and SSIM / MS-SSIM within ``SSIM_TOL`` of the JAX
  metrics;
* sample_mjpeg_transcode: the JAX sample's PSNR line within
  ``PSNR_TOL`` dB (it runs its split-bf16 default), and, at float32 on
  both sides, every output coefficient within 1 of the JAX
  transcoder's (the bar of tests/test_torch_jpeg_transcode.py).
"""

import re

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_samples_io import run_jax_sample, run_sample
from videoprocessingframework_torch.io import JpegCoefDecoder
from videoprocessingframework_torch.samples import (
    sample_flow_interp,
    sample_measure_video_quality,
    sample_mjpeg_transcode,
    sample_stabilize,
)
from videoprocessingframework_torch.samples._utils import yuv420_luma

CPU = torch.device("cpu")
#: px: motion and corrections, the port's float32 flow vs XLA's
FLOW_TOL = 0.01
#: dB
PSNR_TOL = 0.05
SSIM_TOL = 1e-4


def _shots(out):
    return re.findall(r"shot \d+: frames \[\d+, \d+\)", out)


def test_sample_scenecut(test_mp4):
    out = run_sample("sample_scenecut", test_mp4, "--frames", "32",
                     "--batch", "16")
    assert "1 shot(s)" in out
    assert "frames [0, 32)" in out
    want = run_jax_sample("sample_scenecut.py", test_mp4, "--frames", "32",
                          "--batch", "16")
    assert _shots(out) == _shots(want) == ["shot 0: frames [0, 32)"]


def _luma(src, n):
    return np.stack(list(yuv420_luma(src, n)[1]))


def test_sample_stabilize(test_mp4):
    out = run_sample("sample_stabilize", test_mp4, "--frames", "8",
                     "--jitter", "2")
    assert "after stabilization" in out


def test_sample_stabilize_matches_jax(test_mp4):
    from videoprocessingframework_tpu.ops import stabilize as js

    clip, _ = sample_stabilize.add_jitter(_luma(test_mp4, 8), 2)
    out, corr, raw, res = sample_stabilize.run(clip, sigma=5.0, device=CPU)
    jout, jcorr = js.stabilize_clip(clip, sigma=5.0)
    jraw = float(jnp.abs(js.global_translations(clip)).mean())
    jres = float(jnp.abs(js.global_translations(jout)).mean())
    assert abs(raw - jraw) <= FLOW_TOL and abs(res - jres) <= FLOW_TOL
    np.testing.assert_allclose(corr, np.asarray(jcorr), atol=FLOW_TOL)
    assert res < raw / 4  # the injected shake is gone


def test_sample_flow_interp(test_mp4):
    out = run_sample("sample_flow_interp", test_mp4, "--triplets", "1",
                     "--mv")
    assert "midpoint PSNR" in out
    assert "codec MVs:" in out
    assert "mean gain over frame-repeat" in out


def test_sample_flow_interp_matches_jax(test_mp4):
    from videoprocessingframework_tpu.ops import flow as jflow

    prev, mid, nxt = _luma(test_mp4, 3)
    got = sample_flow_interp.run(prev, mid, nxt, levels=3, iters=4,
                                 device=CPU)
    kw = dict(levels=3, iters=4)
    flow = np.asarray(jflow.lucas_kanade_flow(prev[None], nxt[None], **kw))
    synth = np.asarray(jflow.interpolate_midpoint(prev[None], nxt[None],
                                                  **kw))[0]
    assert abs(got["flow"] - float(np.median(
        np.hypot(flow[..., 0], flow[..., 1])))) <= FLOW_TOL
    assert abs(got["synth"] - sample_flow_interp.psnr(synth, mid)) \
        <= PSNR_TOL
    assert got["repeat"] == sample_flow_interp.psnr(prev, mid)
    assert got["synth"] > got["repeat"]


def test_sample_measure_video_quality(test_mp4):
    out = run_sample("sample_measure_video_quality", test_mp4, "--frames",
                     "16")
    assert "PSNR avg" in out and "SSIM avg" in out
    assert "MS-SSIM (luma) avg" in out


def test_sample_measure_video_quality_matches_jax(test_mp4):
    """The frames the JAX package decodes are the port's originals (bit
    for bit), and its metrics on the port's round trip agree. (The
    encoder's rate control does not repeat its packets exactly from one
    run to the next at this setting, so the reconstructions are
    compared through the metrics, not bit for bit.)"""
    from videoprocessingframework_tpu import compat as jnvc
    from videoprocessingframework_tpu.ops import metrics as jm

    a, b = sample_measure_video_quality.round_trip(test_mp4, "2M", 16, "cpu")
    assert a.shape == b.shape == (16, 696, 848)
    dec = jnvc.PyNvDecoder(test_mp4, 0)
    frame = np.ndarray(shape=(0,), dtype=np.uint8)
    for want in a:
        assert dec.DecodeSingleFrame(frame)
        np.testing.assert_array_equal(frame.reshape(want.shape), want)
    p, s, ms = sample_measure_video_quality.run(a, b, device=CPU)
    np.testing.assert_allclose(p, np.asarray(jm.psnr(a, b)), atol=PSNR_TOL)
    np.testing.assert_allclose(s, np.asarray(jm.ssim(a, b)), atol=SSIM_TOL)
    np.testing.assert_allclose(ms, np.asarray(jm.ms_ssim(a[:, :464],
                                                         b[:, :464])),
                               atol=SSIM_TOL)


def test_sample_mjpeg_transcode(tmp_path):
    out = run_sample("sample_mjpeg_transcode", "synth",
                     str(tmp_path / "t.mjpeg"), "--size", "160x120")
    assert "transcoded 8 frames" in out
    assert "PSNR" in out
    want = run_jax_sample("sample_mjpeg_transcode.py", "synth",
                          str(tmp_path / "j.mjpeg"), "--size", "160x120")

    def db(text):
        return float(re.search(r"PSNR vs source decode: ([\d.]+) dB",
                               text).group(1))

    assert abs(db(out) - db(want)) <= PSNR_TOL


def _split_jpegs(data: bytes) -> list:
    out, start = [], 0
    while start < len(data):
        end = data.index(b"\xff\xd9", start) + 2
        out.append(data[start:end])
        start = end
    return out


def test_sample_mjpeg_transcode_matches_jax(tmp_path):
    from videoprocessingframework_tpu.io import MjpegTranscoder as JT

    src = sample_mjpeg_transcode.make_clip(tmp_path / "src.mjpeg", 320, 240,
                                           8, CPU)
    st = sample_mjpeg_transcode.run(src, str(tmp_path / "p.mjpeg"),
                                    quality=90, out_size=(120, 160),
                                    frames=0, batch=8, device=CPU)
    assert st.frames == 8
    with JT(src, str(tmp_path / "j.mjpeg"), quality=90, out_size=(120, 160),
            batch=8, compute="highest") as t:
        t.run()
    got = _split_jpegs((tmp_path / "p.mjpeg").read_bytes())
    want = _split_jpegs((tmp_path / "j.mjpeg").read_bytes())
    assert len(got) == len(want) == 8
    dec = JpegCoefDecoder()
    for g, w in zip(got, want):
        for cg, cw in zip(dec.decode(g), dec.decode(w)):
            assert cg.shape == cw.shape
            assert np.abs(cg.astype(int) - cw.astype(int)).max() <= 1
