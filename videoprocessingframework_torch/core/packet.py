"""Packet / seek / colorimetry metadata types.

Python-native equivalents of the reference's POD structs:
``PacketData`` (src/TC/inc/CodecsSupport.hpp:19-26), ``SeekContext``
(src/TC/inc/FFmpegDemuxer.h:50-130), ``ColorspaceConversionContext``
(src/TC/inc/MemoryInterfaces.hpp:63-71) and ``MuxingParams``
(CodecsSupport.hpp:28-49).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .enums import ColorRange, ColorSpace, CodecId, PixelFormat, SeekMode


@dataclass
class PacketData:
    """Per-packet metadata. ``bsl`` is the bitstream length in bytes."""

    key: int = 0
    pts: int = -1
    dts: int = -1
    pos: int = 0
    bsl: int = 0
    duration: int = 0

    def __repr__(self) -> str:  # same fields the reference prints
        return (
            f"PacketData(key={self.key}, pts={self.pts}, dts={self.dts}, "
            f"pos={self.pos}, bsl={self.bsl}, duration={self.duration})"
        )


@dataclass
class SeekContext:
    """Seek request + result.

    Construct with ``seek_frame=`` (frame number) or ``seek_tssec=``
    (timestamp in seconds), optionally with a :class:`SeekMode`. After the
    seek executes, ``out_frame_pts`` / ``out_frame_duration`` /
    ``num_frames_decoded`` are filled in.
    """

    seek_frame: int = -1
    seek_tssec: float = -1.0
    mode: SeekMode = SeekMode.PREV_KEY_FRAME
    use_seek: bool = field(default=False)
    out_frame_pts: int = -1
    out_frame_duration: int = -1
    num_frames_decoded: int = -1

    def __post_init__(self):
        if self.seek_frame >= 0 or self.seek_tssec >= 0.0:
            self.use_seek = True

    @property
    def is_by_number(self) -> bool:
        return self.seek_frame >= 0

    @property
    def is_by_timestamp(self) -> bool:
        return self.seek_tssec >= 0.0

    # Reference-compatible spellings
    def IsByNumber(self) -> bool:
        return self.is_by_number

    def IsByTimestamp(self) -> bool:
        return self.is_by_timestamp


@dataclass
class ColorspaceConversionContext:
    """Colorimetry for a conversion; defaults mean "unspecified"."""

    color_space: ColorSpace = ColorSpace.UNSPEC
    color_range: ColorRange = ColorRange.UDEF


@dataclass
class MuxingParams:
    """Stream properties reported by the demuxer / decoder."""

    width: int = 0
    height: int = 0
    gop_size: int = 0
    num_frames: int = 0
    is_vfr: bool = False
    frame_rate: float = 0.0
    avg_frame_rate: float = 0.0
    time_base: float = 0.0
    stream_index: int = 0
    codec: CodecId = CodecId.UNDEFINED
    format: PixelFormat = PixelFormat.UNDEFINED
    color_space: ColorSpace = ColorSpace.UNSPEC
    color_range: ColorRange = ColorRange.UDEF
