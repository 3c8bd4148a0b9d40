"""The port's host I/O and Surface samples
(videoprocessingframework_torch/samples: sample_decode, sample_decode_sw,
sample_demux_decode, sample_decode_rtsp, sample_encode,
sample_encode_multi_thread, sample_transcode, sample_dlpack, sample_torch,
sample_remap, sample_display) on the CPU.

Each test of tests/test_samples.py for these samples has a counterpart
here that runs the port's sample with ``--device cpu`` and the same
arguments, in a subprocess, and asserts the same printed line. The
decoders' output files are bit-equal to the JAX samples' (run as
tests/test_samples.py runs them), and the remapped frames are within 1
code of the JAX package's compat chain on the same frames.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import videoprocessingframework_torch.compat as nvc
from videoprocessingframework_torch.samples import sample_remap

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 300  # seconds a sample run may take
#: torch's intra-op threads in a sample's process: the suite runs several
#: test files at once, and each sample would otherwise start a thread per
#: core
SAMPLE_THREADS = "2"


def run_sample(name: str, *args: str, device="cpu", ok=True) -> str:
    """``python -m videoprocessingframework_torch.samples.<name> args
    --device <device>`` from the repository root, headless; its stdout
    and stderr."""
    env = {k: v for k, v in os.environ.items() if k != "DISPLAY"}
    env.setdefault("OMP_NUM_THREADS", SAMPLE_THREADS)
    cmd = [sys.executable, "-m", f"videoprocessingframework_torch.samples."
           f"{name}", *args]
    if device is not None:
        cmd += ["--device", device]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=TIMEOUT, env=env, cwd=str(ROOT))
    out = proc.stdout + proc.stderr
    assert (proc.returncode == 0) == ok, f"{name} exited " \
        f"{proc.returncode}:\n{out}"
    return out


def run_jax_sample(script: str, *args: str) -> str:
    """A sample of the JAX package on its CPU backend, as
    tests/test_samples.py runs it."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["VPF_TPU_FORCE_CPU"] = "1"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "samples" / script), *args],
        capture_output=True, text=True, timeout=TIMEOUT, env=env,
        cwd=str(ROOT))
    assert proc.returncode == 0, f"{script}:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout + proc.stderr


def _line(out: str, text: str) -> str:
    """The message of the first log line holding ``text``."""
    line = next(ln for ln in out.splitlines() if text in ln)
    return line.split("] ", 1)[1]


# ---- decode -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["builtin", "standalone"])
def test_sample_decode(test_mp4, tmp_path, mode):
    out = run_sample("sample_decode", test_mp4, str(tmp_path / "o.nv12"),
                     "--mode", mode)
    assert "decoded 96 frames" in out
    run_jax_sample("sample_decode.py", test_mp4, str(tmp_path / "j.nv12"),
                   "--mode", mode)
    got = (tmp_path / "o.nv12").read_bytes()
    assert len(got) == 96 * 848 * 464 * 3 // 2
    assert got == (tmp_path / "j.nv12").read_bytes()


def test_sample_decode_seek(test_mp4, tmp_path):
    out = run_sample("sample_decode", test_mp4, str(tmp_path / "o.nv12"),
                     "--mode", "seek", "--seek-frame", "50")
    assert "decoded" in out


def test_sample_decode_sw(test_mp4, tmp_path):
    out = run_sample("sample_decode_sw", test_mp4, str(tmp_path / "o.yuv"))
    assert "decoded 96 frames" in out
    run_jax_sample("sample_decode_sw.py", test_mp4, str(tmp_path / "j.yuv"))
    assert (tmp_path / "o.yuv").read_bytes() == \
        (tmp_path / "j.yuv").read_bytes()


def test_sample_demux_decode(test_mp4):
    out = run_sample("sample_demux_decode", test_mp4)
    assert "decoded 96 surfaces" in out
    want = run_jax_sample("sample_demux_decode.py", test_mp4)
    assert _line(out, "decoded") == _line(want, "decoded")


def test_sample_decode_rtsp_file_url(test_mp4):
    out = run_sample("sample_decode_rtsp", test_mp4, test_mp4, "--seconds",
                     "30")
    lines = [ln for ln in out.splitlines() if "frames in 30s" in ln]
    assert len(lines) == 2


# ---- encode and transcode ---------------------------------------------------


def test_sample_encode_roundtrip(test_mp4, tmp_path):
    raw = tmp_path / "frames.nv12"
    run_sample("sample_decode", test_mp4, str(raw))
    out = run_sample("sample_encode", str(raw), str(tmp_path / "enc.h264"),
                     "848", "464", "--preset", "P1")
    assert "sent 96 frames, wrote 96 packets" in out


def test_sample_encode_multi_thread():
    out = run_sample("sample_encode_multi_thread", "--threads", "2",
                     "--frames", "10")
    assert "aggregate" in out


def test_sample_transcode(test_mp4, tmp_path):
    out = run_sample("sample_transcode", test_mp4, str(tmp_path / "t.h264"),
                     "--scale", "424x232")
    assert "transcoded 96 frames -> 96 packets" in out


# ---- surfaces and tensors ---------------------------------------------------


def test_sample_remap(test_mp4):
    out = run_sample("sample_remap", test_mp4, "--frames", "2")
    assert "remapped 2 frames" in out


def test_sample_remap_matches_jax(test_mp4):
    """Remapped RGB frames, the port's run vs the JAX package's compat
    chain (PySurfaceConverter NV12 → RGB → PySurfaceRemaper) on the same
    two decoded frames: within 1 code."""
    from videoprocessingframework_tpu import compat as jnvc

    xmap, ymap = sample_remap.barrel_maps(848, 464)
    jdec = jnvc.PyNvDecoder(test_mp4, 0)
    jcc = jnvc.ColorspaceConversionContext(jdec.ColorSpace(),
                                           jdec.ColorRange())
    jconv = jnvc.PySurfaceConverter(848, 464, jnvc.PixelFormat.NV12,
                                    jnvc.PixelFormat.RGB, 0)
    jremap = jnvc.PySurfaceRemaper(xmap, ymap, jnvc.PixelFormat.RGB, 0)
    jdown = jnvc.PySurfaceDownloader(848, 464, jnvc.PixelFormat.RGB, 0)
    dec = nvc.PyNvDecoder(test_mp4, "cpu")
    cc = nvc.ColorspaceConversionContext(dec.ColorSpace(), dec.ColorRange())
    down = nvc.PySurfaceDownloader(848, 464, nvc.PixelFormat.RGB, "cpu")
    surfaces = [dec.DecodeSingleSurface() for _ in range(2)]
    got = list(sample_remap.run(surfaces, xmap, ymap, cc, "cpu"))
    assert len(got) == 2
    a, b = np.ndarray(shape=(0,), dtype=np.uint8), np.ndarray(
        shape=(0,), dtype=np.uint8)
    for surf in got:
        want = jremap.Execute(jconv.Execute(jdec.DecodeSingleSurface(), jcc))
        assert down.DownloadSingleSurface(surf, a)
        assert jdown.DownloadSingleSurface(want, b)
        assert a.size == b.size == 848 * 464 * 3
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_sample_dlpack(test_mp4):
    out = run_sample("sample_dlpack", test_mp4)
    assert "as torch tensor" in out


def test_sample_torch(test_mp4):
    out = run_sample("sample_torch", test_mp4, "--frames", "3")
    assert "round-tripped 3 frames" in out


def test_sample_display_headless(test_mp4):
    out = run_sample("sample_display", test_mp4, "--frames", "3")
    assert "processed 3 frames" in out
