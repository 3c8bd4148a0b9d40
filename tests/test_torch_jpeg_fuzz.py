"""Seeded fuzzing of the port's JPEG entropy coder (``libvpf_jpeg``)
against the JAX package's copy of the same parser (in its
``libvpf_host``), with the corruptions of tests/test_jpeg_fuzz.py:
random bytes, truncations, point mutations, smashed segment lengths,
valid headers over random entropy data, and the same on a progressive
stream.

For every input both libraries must return the same status codes from
``vpf_jpeg_probe`` and ``vpf_jpeg_parse``, the same error message, and,
where the parse succeeds, the same info struct and coefficients; the
port's ``JpegCoefDecoder`` must raise only its typed errors. The loop
runs in a subprocess, so a crash fails the test by its return code
instead of killing the runner.
"""

import os
import subprocess
import sys

_FUZZ = r"""
import ctypes as C, io, sys
import numpy as np
sys.path.insert(0, __REPO__)
from videoprocessingframework_torch.io import _jpeg_lib as P
from videoprocessingframework_torch.io.jpeg import (
    JpegCoefDecoder, JpegCoefEncoder, JpegStreamError,
)
from videoprocessingframework_torch.ops.jpeg import JpegDeviceEncoder
from videoprocessingframework_tpu.io import _lib as JL

W, H = 48, 32
rng = np.random.default_rng(20260817)
enc = JpegDeviceEncoder(H, W, quality=80, device="cpu")
planes = (rng.integers(0, 256, (1, H, W), np.uint8),
          rng.integers(0, 256, (1, H // 2, W // 2), np.uint8),
          rng.integers(0, 256, (1, H // 2, W // 2), np.uint8))
coeffs = [c.numpy()[0] for c in enc.encode_planes(*planes)]
valid = np.frombuffer(JpegCoefEncoder(W, H, quant_tables=enc.quant_tables)
                      .encode(*coeffs), np.uint8)

LIBS = ((P.load(), P.VpfJpegInfo, P.last_error),
        (JL.load(), JL.VpfJpegInfo, JL.last_error))
u8p, i16p = C.POINTER(C.c_uint8), C.POINTER(C.c_int16)


def status(lib, Info, last_error, a):
    info = Info()
    rc = lib.vpf_jpeg_probe(a.ctypes.data_as(u8p), a.size, C.byref(info))
    if rc != 1:
        return (rc, last_error())
    n = int(info.ncomp)
    bufs = [np.zeros((int(info.bh[c]) * int(info.bw[c]), 64), np.int16)
            for c in range(n)]
    ptrs = (i16p * n)(*(b.ctypes.data_as(i16p) for b in bufs))
    caps = (C.c_uint32 * 4)(*(b.shape[0] for b in bufs), *([0] * (4 - n)))
    out = Info()
    rp = lib.vpf_jpeg_parse(a.ctypes.data_as(u8p), a.size, C.byref(out),
                            ptrs, caps)
    if rp != 1:
        return (rc, rp, last_error())
    return (rc, rp, bytes(out), b"".join(b.tobytes() for b in bufs))


ok = bad = 0
def feed(data):
    global ok, bad
    a = np.ascontiguousarray(data, np.uint8)
    mine, theirs = (status(*lib, a) for lib in LIBS)
    assert mine == theirs, (mine[:3], theirs[:3], bytes(a[:32]))
    try:
        JpegCoefDecoder().decode(a)
        ok += 1
    except (JpegStreamError, ValueError):
        bad += 1


def gauntlet(v, n_trunc, n_mut, n_len, bodies):
    for _ in range(n_trunc):
        feed(v[: int(rng.integers(0, v.size))].copy())
    for _ in range(n_mut):
        m = v.copy()
        for _k in range(int(rng.integers(1, 5))):
            m[int(rng.integers(0, m.size))] = int(rng.integers(0, 256))
        feed(m)
    for _ in range(n_len):
        m = v.copy()
        idxs = np.flatnonzero(m[:-3] == 0xFF)
        if idxs.size:
            i = int(idxs[int(rng.integers(0, idxs.size))])
            m[i + 2: i + 4] = rng.integers(0, 256, 2, np.uint8)
        feed(m)
    sos = bytes(v).find(b"\xff\xda")
    hdr = v[: sos + 2 + ((int(v[sos + 2]) << 8) | int(v[sos + 3]))]
    for n in bodies:
        for _ in range(40):
            body = rng.integers(0, 256, n, np.uint8)
            feed(np.concatenate([hdr, body,
                                 np.frombuffer(b"\xff\xd9", np.uint8)]))


feed(valid)
assert ok == 1
for n in (0, 1, 2, 3, 7, 64, 256, 4096):
    for _ in range(25):
        feed(rng.integers(0, 256, n, np.uint8))
gauntlet(valid, 200, 1000, 200, (0, 1, 17, 300, valid.size))

from PIL import Image
img = rng.integers(0, 256, (H, W, 3), np.uint8)
bio = io.BytesIO()
Image.fromarray(img).save(bio, "JPEG", quality=80, progressive=True)
pvalid = np.frombuffer(bio.getvalue(), np.uint8)
before = ok
feed(pvalid)
assert ok == before + 1
gauntlet(pvalid, 150, 800, 100, (0, 1, 17, 300))
print(f"fuzz done: {ok} decoded, {bad} rejected cleanly, statuses equal")
"""


def test_jpeg_parser_fuzz_equals_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _FUZZ.replace("__REPO__", repr(repo))],
        capture_output=True, text=True, timeout=480,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, (
        f"fuzz loop died (rc={proc.returncode}):\n{proc.stdout}\n"
        f"{proc.stderr[-3000:]}")
    assert "fuzz done" in proc.stdout
