"""ctypes binding over the native host runtime (libvpf_host.so).

Binds only what this package calls: the decode pool (``vpf_pool_*``), a
demuxer probe for the stream's size and colorimetry, the encoder that
makes test clips, and ``vpf_last_error``. ctypes drops the GIL for every
call, so native work never holds the interpreter.
"""

from __future__ import annotations

import ctypes as C
import functools

from ..core.enums import ColorRange, ColorSpace
from . import build


class VpfPacketData(C.Structure):
    _fields_ = [
        ("key", C.c_int32),
        ("pts", C.c_int64),
        ("dts", C.c_int64),
        ("pos", C.c_uint64),
        ("bsl", C.c_uint64),
        ("duration", C.c_uint64),
    ]


class VpfStreamProps(C.Structure):
    _fields_ = [
        ("width", C.c_uint32),
        ("height", C.c_uint32),
        ("gop_size", C.c_uint32),
        ("num_frames", C.c_int64),
        ("is_vfr", C.c_uint32),
        ("frame_rate", C.c_double),
        ("avg_frame_rate", C.c_double),
        ("time_base", C.c_double),
        ("stream_index", C.c_uint32),
        ("codec", C.c_int32),
        ("pixel_format", C.c_int32),
        ("color_space", C.c_int32),
        ("color_range", C.c_int32),
        ("start_time", C.c_int64),
        ("bit_depth", C.c_uint32),
    ]


# return codes (common.hpp VpfStatus)
OK = 1
NEED_MORE = 0
ERR = -1
ERR_EOF = -4

_u8p = C.POINTER(C.c_uint8)


@functools.lru_cache(maxsize=1)
def load() -> C.CDLL:
    lib = C.CDLL(str(build.build()))

    def sig(name, restype, argtypes):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes

    sig("vpf_last_error", C.c_char_p, [])

    sig("vpf_demuxer_open", C.c_void_p,
        [C.c_char_p, C.POINTER(C.c_char_p), C.POINTER(C.c_char_p), C.c_int])
    sig("vpf_demuxer_close", None, [C.c_void_p])
    sig("vpf_demuxer_get_props", C.c_int,
        [C.c_void_p, C.POINTER(VpfStreamProps)])

    sig("vpf_encoder_create", C.c_void_p,
        [C.POINTER(C.c_char_p), C.POINTER(C.c_char_p), C.c_int, C.c_int])
    sig("vpf_encoder_destroy", None, [C.c_void_p])
    sig("vpf_encoder_encode", C.c_int,
        [C.c_void_p, _u8p, C.c_size_t, _u8p, C.c_size_t, C.c_int64])
    sig("vpf_encoder_packet", C.c_int,
        [C.c_void_p, C.POINTER(_u8p), C.POINTER(C.c_size_t),
         C.POINTER(VpfPacketData)])

    sig("vpf_pool_create", C.c_void_p,
        [C.POINTER(C.c_char_p), C.c_int, C.c_int, C.c_size_t, C.c_int,
         C.c_int, C.c_int64, C.c_int, C.c_int])
    sig("vpf_pool_acquire_batch", C.c_int,
        [C.c_void_p, C.POINTER(_u8p), C.POINTER(C.c_int)])
    sig("vpf_pool_release_batch", None, [C.c_void_p])
    sig("vpf_pool_pause", None, [C.c_void_p, C.c_int])
    sig("vpf_pool_worker_priority", None, [C.c_void_p, C.c_int])
    sig("vpf_pool_frames_decoded", C.c_long, [C.c_void_p])
    sig("vpf_pool_frames_dropped", C.c_long, [C.c_void_p])
    sig("vpf_pool_drop_reason", C.c_char_p, [C.c_void_p])
    sig("vpf_pool_destroy", None, [C.c_void_p])
    return lib


def last_error() -> str:
    return load().vpf_last_error().decode("utf-8", "replace")


def make_string_arrays(d: dict) -> tuple:
    keys = (C.c_char_p * len(d))(*[k.encode() for k in d])
    vals = (C.c_char_p * len(d))(*[str(v).encode() for v in d.values()])
    return keys, vals, len(d)


def probe(url: str) -> dict:
    """Width, height, colour space and range of a stream's video track."""
    lib = load()
    keys, vals, n = make_string_arrays({})
    h = lib.vpf_demuxer_open(str(url).encode(), keys, vals, n)
    if not h:
        raise RuntimeError(f"demuxer open failed: {last_error()}")
    try:
        props = VpfStreamProps()
        lib.vpf_demuxer_get_props(h, C.byref(props))
    finally:
        lib.vpf_demuxer_close(h)
    return dict(
        width=props.width,
        height=props.height,
        color_space=ColorSpace(props.color_space),
        color_range=ColorRange(props.color_range),
    )
