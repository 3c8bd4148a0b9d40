"""Core enums: pixel formats, colorimetry, seek modes, codec ids.

Enum values mirror the reference's public enum values so that code written
against the reference's Python API behaves identically
(reference: src/TC/inc/MemoryInterfaces.hpp:30-61, FFmpegDemuxer.h:39-48).
"""

from __future__ import annotations

import enum


class PixelFormat(enum.IntEnum):
    """Pixel format of a decoded frame's planes."""

    UNDEFINED = 0
    Y = 1
    RGB = 2
    NV12 = 3
    YUV420 = 4
    RGB_PLANAR = 5
    BGR = 6
    YCBCR = 7
    YUV444 = 8
    RGB_32F = 9
    RGB_32F_PLANAR = 10
    YUV422 = 11
    P10 = 12
    P12 = 13
    YUV444_10bit = 14
    YUV420_10bit = 15
    NV12_PLANAR = 16
    GRAY12 = 17


class ColorSpace(enum.IntEnum):
    """YCbCr matrix coefficients."""

    BT_601 = 0
    BT_709 = 1
    UNSPEC = 2


class ColorRange(enum.IntEnum):
    """Quantization range. MPEG = narrow/studio, JPEG = full."""

    MPEG = 0
    JPEG = 1
    UDEF = 2


class SeekMode(enum.IntEnum):
    """Seek behavior (reference: FFmpegDemuxer.h:39-48).

    EXACT_FRAME: land on the exact requested frame (standalone demux seek).
    PREV_KEY_FRAME: land on the previous key frame (seek & decode).
    """

    EXACT_FRAME = 0
    PREV_KEY_FRAME = 1


class SeekCriteria(enum.IntEnum):
    """What the seek target refers to."""

    BY_NUMBER = 0
    BY_TIMESTAMP = 1


class CodecId(enum.IntEnum):
    """Video codec identifiers (host decode/encode support via libav)."""

    UNDEFINED = 0
    H264 = 1
    HEVC = 2
    VP8 = 3
    VP9 = 4
    MPEG4 = 5
    MPEG2 = 6
    MJPEG = 7
    AV1 = 8
