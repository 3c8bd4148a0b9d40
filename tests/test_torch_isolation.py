"""The port stands alone: importing every module of
``videoprocessingframework_torch`` (and what chip_smoke.py imports) pulls
in neither JAX, Flax, optax nor the JAX package, nor cv2, and loads no
native libav library (the samples keep those inside functions). Checked
in a fresh interpreter."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import ast, importlib, pathlib, pkgutil, sys
import videoprocessingframework_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
tree = ast.parse(pathlib.Path("chip_smoke.py").read_text())
smoke = set()
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
            smoke.add(a.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        importlib.import_module(node.module)
        smoke.add(node.module)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "jaxlib", "optax",
                                    "videoprocessingframework_tpu", "cv2"))
from videoprocessingframework_torch.io import _lib
if _lib.load.cache_info().currsize or "libvpf_host" in pathlib.Path(
        "/proc/self/maps").read_text():
    bad.append("libvpf_host")
print(" ".join(sorted(smoke)))
print(" ".join(names))
print(len(names))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    smoke, names, n, bad = r.stdout.strip().splitlines()[-4:]
    assert int(n) >= 89  # every module of the port was imported
    for mod in ("compat", "parallel.streams", "io.transcode", "io.muxer",
                "io.encoder", "io.jpeg", "ops.jpeg", "data.mjpeg",
                "parallel.mesh", "parallel.multidevice",
                "parallel.multihost", "samples.sample_resnet",
                "samples._utils"):
        assert f"videoprocessingframework_torch.{mod}" in names.split()
    # chip_smoke.py's phase 13 (the mesh, the sharded and multi-host
    # pipelines) and phase 14 (the samples) are among what was imported
    for mod in ("parallel.mesh", "parallel.multidevice",
                "parallel.multihost", "samples"):
        assert f"videoprocessingframework_torch.{mod}" in smoke.split()
    assert bad == "BAD []"


def test_port_sources_name_no_jax():
    """No source of the port (nor chip_smoke.py) imports JAX, Flax, optax
    or the JAX package, even on a path the import above does not reach."""
    files = list((ROOT / "videoprocessingframework_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in (
                    "jax", "flax", "jaxlib", "optax",
                    "videoprocessingframework_tpu"
                ), f"{f}: {s}"


_JPEG_ALONE = r"""
import pathlib, sys
import numpy as np
from videoprocessingframework_torch.io import _lib, build
missing = build.libav_missing()
assert missing, "pkg-config found libav"
build.OUT_DIR = pathlib.Path(sys.argv[1])  # a fresh build, not the cache
from videoprocessingframework_torch.io import jpeg
coder = jpeg.JpegCoefEncoder(16, 16)
coeffs = [np.zeros((4, 64), np.int16)] + [np.zeros((1, 64), np.int16)] * 2
coeffs[0][:, 0] = [10, -20, 30, -40]
back = jpeg.JpegCoefDecoder().decode(coder.encode(*coeffs))
assert all(np.array_equal(b, c) for b, c in zip(back, coeffs))
maps = pathlib.Path("/proc/self/maps").read_text()
assert "libvpf_jpeg" in maps and "libvpf_host" not in maps
assert _lib.load.cache_info().currsize == 0
print(sorted(p.name for p in build.OUT_DIR.glob("*.so")))
"""


def test_jpeg_library_builds_without_libav(tmp_path):
    """io.jpeg builds libvpf_jpeg with g++ alone: pkg-config, pointed at
    an empty directory, finds no libav, and libvpf_host is neither built
    nor loaded."""
    empty = tmp_path / "pkgconfig"
    empty.mkdir()
    env = {**os.environ, "PKG_CONFIG_PATH": str(empty),
           "PKG_CONFIG_LIBDIR": str(empty)}
    r = subprocess.run(
        [sys.executable, "-c", _JPEG_ALONE, str(tmp_path / "build")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env,
    )
    assert r.returncode == 0, r.stderr
    libs = r.stdout.strip().splitlines()[-1]
    assert "libvpf_jpeg-" in libs and "libvpf_host" not in libs
