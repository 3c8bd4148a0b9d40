"""Build the native host libraries from the package's own C++ sources
(``io/native/``), at first use with g++, into the gitignored
``io/_native_build/``, under a file lock with an atomic rename (see
``utils/build_cache.py``):

* ``libvpf_host`` (:func:`build`): the libav runtime — demuxer, decoder,
  decode pool, encoder and muxer — against the libav development files
  found by pkg-config;
* ``libvpf_jpeg`` (:func:`build_jpeg`): the JPEG entropy coder alone
  (``jpeg.cpp`` + ``status.hpp``), which needs no libav, so it builds
  wherever g++ does.
"""

from __future__ import annotations

import pathlib
import subprocess

from ..utils.build_cache import cached_build

_HERE = pathlib.Path(__file__).parent
SRC = _HERE / "native"
OUT_DIR = _HERE / "_native_build"
SOURCES = ["demuxer.cpp", "decoder.cpp", "encoder.cpp", "pool.cpp",
           "muxer.cpp"]
_LIBAV = ("libavformat", "libavcodec", "libavutil")
CFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fvisibility=hidden"]


def _pkg_config(*args: str) -> list[str]:
    out = subprocess.check_output(["pkg-config", *args, *_LIBAV], text=True,
                                  stderr=subprocess.STDOUT)
    return out.split()


def libav_missing() -> str:
    """'' when the libav development files are present, else why not."""
    try:
        _pkg_config("--modversion")
    except FileNotFoundError:
        return "pkg-config is not installed"
    except subprocess.CalledProcessError as e:
        return " ".join(e.output.split()[:16])
    return ""


def build() -> pathlib.Path:
    """Compile (once per source hash) and return the library's path."""
    missing = libav_missing()
    if missing:
        raise RuntimeError(f"libav development files not found: {missing}")
    flags = _pkg_config("--cflags") + _pkg_config("--libs")
    return cached_build(
        OUT_DIR, "libvpf_host",
        [SRC / "status.hpp", SRC / "common.hpp"] + [SRC / s for s in SOURCES],
        lambda out: [[["g++", *CFLAGS, *[str(SRC / s) for s in SOURCES],
                       *flags, "-o", str(out)]]],
        key=" ".join(CFLAGS + flags),
    )


def build_jpeg() -> pathlib.Path:
    """Compile (once per source hash) and return ``libvpf_jpeg``'s path:
    g++ and the package's sources only, no pkg-config."""
    return cached_build(
        OUT_DIR, "libvpf_jpeg",
        [SRC / "status.hpp", SRC / "jpeg.cpp"],
        lambda out: [[["g++", *CFLAGS, str(SRC / "jpeg.cpp"), "-o",
                       str(out)]]],
        key=" ".join(CFLAGS),
    )
