"""ctypes binding over the JPEG entropy coder (``libvpf_jpeg.so``, built
from ``io/native/jpeg.cpp`` with no libav: ``build.build_jpeg``).

Binds ``vpf_jpeg_probe``, ``vpf_jpeg_parse``, ``vpf_jpeg_encode`` and the
library's own ``vpf_last_error``: its thread-local error slot is not
``libvpf_host``'s, so errors of the coder are read here. Loading this
library never builds nor loads ``libvpf_host``. ctypes drops the GIL for
every call, so coders on several threads run in parallel.
"""

from __future__ import annotations

import ctypes as C
import functools

from . import build


class VpfJpegInfo(C.Structure):
    _fields_ = [
        ("width", C.c_uint32),
        ("height", C.c_uint32),
        ("ncomp", C.c_uint32),
        ("hs", C.c_uint32 * 4),
        ("vs", C.c_uint32 * 4),
        ("bw", C.c_uint32 * 4),
        ("bh", C.c_uint32 * 4),
        ("qt", (C.c_uint16 * 64) * 4),
        ("restart_interval", C.c_uint32),
        ("max_k", C.c_uint32),
        ("consumed", C.c_uint32),
        ("progressive", C.c_uint32),
    ]


class VpfJpegEncParams(C.Structure):
    _fields_ = [
        ("width", C.c_uint32),
        ("height", C.c_uint32),
        ("ncomp", C.c_uint32),
        ("subsampled", C.c_uint32),
        ("restart_interval", C.c_uint32),
        ("qt_luma", C.c_uint16 * 64),
        ("qt_chroma", C.c_uint16 * 64),
    ]


# return codes (status.hpp VpfStatus)
OK = 1
ERR = -1
ERR_DECODE = -2
ERR_PARSE = -3

u8p = C.POINTER(C.c_uint8)
i16p = C.POINTER(C.c_int16)


@functools.lru_cache(maxsize=1)
def load() -> C.CDLL:
    lib = C.CDLL(str(build.build_jpeg()))

    def sig(name, restype, argtypes):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes

    sig("vpf_last_error", C.c_char_p, [])
    sig("vpf_jpeg_probe", C.c_int, [u8p, C.c_size_t, C.POINTER(VpfJpegInfo)])
    sig("vpf_jpeg_parse", C.c_int,
        [u8p, C.c_size_t, C.POINTER(VpfJpegInfo), C.POINTER(i16p),
         C.POINTER(C.c_uint32)])
    sig("vpf_jpeg_encode", C.c_int,
        [C.POINTER(VpfJpegEncParams), C.POINTER(i16p), u8p, C.c_size_t,
         C.POINTER(C.c_size_t)])
    return lib


def last_error() -> str:
    """This thread's last error of the JPEG library."""
    return load().vpf_last_error().decode("utf-8", "replace")
