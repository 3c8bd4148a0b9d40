"""Build and bind the package's CUDA kernels.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles every ``*.cu``
here, one nvcc per source, all started together, and links the objects
into one shared library with a plain C interface, loaded with ctypes (no
PyTorch headers, so a build takes seconds). The build runs at first use
into the gitignored ``csrc/_build/``, keyed by a content hash of the
sources, the ``*.cuh`` headers they include and the flags. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes as C
import functools
import os
import pathlib
import shutil

from ..utils.build_cache import cached_build

_HERE = pathlib.Path(__file__).parent
OUT_DIR = _HERE / "_build"
SOURCES = sorted(_HERE.glob("*.cu"))
HEADERS = sorted(_HERE.glob("*.cuh"))
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xcompiler", "-fvisibility=hidden"]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> pathlib.Path:
    """Compile (once per source hash) and return the library's path."""
    compiler = nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]

    def steps(out: pathlib.Path):
        objs = [str(out.parent / f"{src.stem}.o") for src in SOURCES]
        return [
            [[compiler, *compile_flags, "-c", str(src), "-o", obj]
             for src, obj in zip(SOURCES, objs)],
            [[compiler, ARCH, "-shared", *objs, "-o", str(out)]],
        ]

    return cached_build(OUT_DIR, "libvpf_kernels", [*SOURCES, *HEADERS],
                        steps, key=" ".join(NVCC_FLAGS))


@functools.lru_cache(maxsize=1)
def load_kernels() -> C.CDLL:
    """The kernel library with its C signatures bound."""
    lib = C.CDLL(str(build()))
    p, i, i64 = C.c_void_p, C.c_int, C.c_int64
    fused = ([p, p, p, i, i, i64, i64, i64, i64] + [p, p, i] * 4
             + [p, i, i, i, C.POINTER(C.c_float)])
    fn = lib.vpf_fused_resize_csc
    fn.restype = i
    fn.argtypes = fused + [C.POINTER(C.c_int32), p, p, p, p]
    fn = lib.vpf_fused_resize_csc_direct
    fn.restype = i
    fn.argtypes = fused + [p]
    fn = lib.vpf_csc_rgb_planar
    fn.restype = i
    fn.argtypes = [p, p, p, i, i, i, i, i64, i64, i64, i64, p, i,
                   C.POINTER(C.c_float), p]
    fn = lib.vpf_layer_norm
    fn.restype = i
    fn.argtypes = [p, i, i64, p, i, p, p, i64, i, C.c_float, p]
    fn = lib.vpf_rope2d
    fn.restype = i
    fn.argtypes = [p, i, i64, i64, i64, i64, p, p, i, i, i, i, i, p]
    lib.vpf_cuda_error_string.restype = C.c_char_p
    lib.vpf_cuda_error_string.argtypes = [i]
    return lib
