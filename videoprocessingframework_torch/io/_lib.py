"""ctypes binding over the native host runtime (libvpf_host.so).

Binds what this package calls: the demuxer (open, demux, seek, timestamp
conversions, parameter sets), the decoder (packets in, frames out, reset,
re-create, the native sequential clip read, capabilities, motion
vectors), the decode pool (``vpf_pool_*``), the encoder (sessions,
packets, reconfiguration, option checks), the muxer and
``vpf_last_error``. ctypes drops the GIL for every call, so
native work never holds the interpreter.
"""

from __future__ import annotations

import ctypes as C
import functools

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


class VpfFrameDesc(C.Structure):
    _fields_ = [
        ("width", C.c_uint32),
        ("height", C.c_uint32),
        ("pixel_format", C.c_int32),
        ("color_space", C.c_int32),
        ("color_range", C.c_int32),
        ("pkt", VpfPacketData),
        ("frame_size", C.c_uint64),
    ]


class VpfCodecCaps(C.Structure):
    _fields_ = [
        ("is_supported", C.c_int32),
        ("max_bit_depth", C.c_int32),
        ("supports_10bit", C.c_int32),
        ("max_width", C.c_int32),
        ("max_height", C.c_int32),
        ("min_width", C.c_int32),
        ("min_height", C.c_int32),
        ("max_bframes", C.c_int32),
        ("supports_lookahead", C.c_int32),
        ("supports_reordered_output", C.c_int32),
    ]


class VpfMotionVector(C.Structure):
    _fields_ = [
        ("source", C.c_int32),
        ("w", C.c_uint8),
        ("h", C.c_uint8),
        ("src_x", C.c_int16),
        ("src_y", C.c_int16),
        ("dst_x", C.c_int16),
        ("dst_y", C.c_int16),
        ("flags", C.c_uint64),
        ("motion_x", C.c_int32),
        ("motion_y", C.c_int32),
        ("motion_scale", C.c_uint16),
    ]


# return codes (common.hpp VpfStatus)
OK = 1
NEED_MORE = 0
ERR = -1
ERR_DECODE = -2
ERR_PARSE = -3
ERR_EOF = -4

READ_CB = C.CFUNCTYPE(C.c_int, C.c_void_p, C.POINTER(C.c_uint8), C.c_int)

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
    sig("vpf_demuxer_open_reader", C.c_void_p, [READ_CB, C.c_void_p])
    sig("vpf_demuxer_close", None, [C.c_void_p])
    sig("vpf_demuxer_get_props", C.c_int,
        [C.c_void_p, C.POINTER(VpfStreamProps)])
    sig("vpf_demuxer_demux", C.c_int,
        [C.c_void_p, C.POINTER(_u8p), C.POINTER(C.c_size_t),
         C.POINTER(VpfPacketData), C.POINTER(_u8p), C.POINTER(C.c_size_t)])
    sig("vpf_demuxer_seek", C.c_int,
        [C.c_void_p, C.c_int64, C.c_double, C.c_int, C.c_int,
         C.POINTER(_u8p), C.POINTER(C.c_size_t), C.POINTER(VpfPacketData),
         C.POINTER(C.c_int64), C.POINTER(C.c_int64)])
    sig("vpf_demuxer_flush", None, [C.c_void_p])
    sig("vpf_demuxer_codec_id", C.c_int, [C.c_void_p])
    sig("vpf_demuxer_ts_from_time", C.c_int64, [C.c_void_p, C.c_double])
    sig("vpf_demuxer_ts_from_frame", C.c_int64, [C.c_void_p, C.c_int64])
    sig("vpf_set_av_log_level", None, [C.c_int])
    sig("vpf_demuxer_extradata", C.c_int,
        [C.c_void_p, C.POINTER(_u8p), C.POINTER(C.c_size_t)])
    sig("vpf_demuxer_annexb_extradata", C.c_int,
        [C.c_void_p, C.POINTER(_u8p), C.POINTER(C.c_size_t)])

    sig("vpf_decoder_create", C.c_void_p,
        [C.c_int, _u8p, C.c_size_t, C.c_int, C.c_int])
    sig("vpf_decoder_destroy", None, [C.c_void_p])
    sig("vpf_decoder_decode", C.c_int,
        [C.c_void_p, _u8p, C.c_size_t, C.POINTER(VpfPacketData)])
    sig("vpf_decoder_flush_frame", C.c_int, [C.c_void_p])
    sig("vpf_decoder_reset", None, [C.c_void_p])
    sig("vpf_decoder_recreate", C.c_int, [C.c_void_p])
    sig("vpf_decoder_frame_desc", C.c_int,
        [C.c_void_p, C.POINTER(VpfFrameDesc)])
    sig("vpf_decoder_copy_frame", C.c_int,
        [C.c_void_p, C.c_int, _u8p, C.c_size_t])
    sig("vpf_read_frames_seq", C.c_long,
        [C.c_void_p, C.c_void_p, C.c_int, _u8p, C.c_size_t, C.c_long,
         C.c_long, C.c_long])
    sig("vpf_codec_caps", C.c_int,
        [C.c_int, C.c_int, C.POINTER(VpfCodecCaps)])
    sig("vpf_decoder_motion_vectors", C.c_int,
        [C.c_void_p, C.POINTER(VpfMotionVector), C.c_size_t,
         C.POINTER(C.c_size_t)])

    sig("vpf_encoder_create", C.c_void_p,
        [C.POINTER(C.c_char_p), C.POINTER(C.c_char_p), C.c_int, C.c_int])
    sig("vpf_encoder_destroy", None, [C.c_void_p])
    sig("vpf_encoder_encode", C.c_int,
        [C.c_void_p, _u8p, C.c_size_t, _u8p, C.c_size_t, C.c_int64])
    sig("vpf_encoder_packet", C.c_int,
        [C.c_void_p, C.POINTER(_u8p), C.POINTER(C.c_size_t),
         C.POINTER(VpfPacketData)])
    sig("vpf_encoder_reconfigure", C.c_int,
        [C.c_void_p, C.POINTER(C.c_char_p), C.POINTER(C.c_char_p), C.c_int,
         C.c_int, C.c_int])
    sig("vpf_encoder_width", C.c_int, [C.c_void_p])
    sig("vpf_encoder_height", C.c_int, [C.c_void_p])
    sig("vpf_encoder_validate_options", C.c_int,
        [C.POINTER(C.c_char_p), C.c_int])

    sig("vpf_muxer_open", C.c_void_p,
        [C.c_char_p, C.c_char_p, C.c_int, C.c_int, C.c_int, C.c_int,
         C.c_int, _u8p, C.c_size_t])
    sig("vpf_muxer_write", C.c_int,
        [C.c_void_p, _u8p, C.c_size_t, C.c_int64, C.c_int64, C.c_int])
    sig("vpf_muxer_close", C.c_int, [C.c_void_p])

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
