"""FFmpegDemuxer — container demux with Annex.B output, SEI extraction and
frame/timestamp seek: the counterpart of the JAX package's
``io/demuxer.py`` over the port's own build of the native demuxer
(io/native/demuxer.cpp).

One difference: a seek the input refuses for want of an index (a raw
elementary stream) raises :class:`~..core.exceptions.UnseekableInputError`
instead of a bare ``RuntimeError``, so callers can tell a refusal from a
failure.
"""

from __future__ import annotations

import ctypes as C
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.enums import CodecId, ColorRange, ColorSpace, PixelFormat, SeekMode
from ..core.exceptions import BitstreamParserException, UnseekableInputError
from ..core.packet import MuxingParams, PacketData, SeekContext
from ..utils.tracing import trace_range
from . import _lib

#: how io/native/demuxer.cpp words a seek on an input without an index
_UNSEEKABLE = "Seek isn't supported"


@dataclass
class DemuxResult:
    packet: np.ndarray  # Annex.B bytes (uint8)
    pkt_data: PacketData
    sei: Optional[np.ndarray] = None


def _pkt_from_c(c: _lib.VpfPacketData) -> PacketData:
    return PacketData(key=c.key, pts=c.pts, dts=c.dts, pos=c.pos, bsl=c.bsl,
                      duration=c.duration)


def _bytes(ptr, size: C.c_size_t) -> np.ndarray:
    return np.ctypeslib.as_array(ptr, shape=(size.value,)).copy()


class FFmpegDemuxer:
    """Demultiplex one video stream from a URL, file, or byte-reader.

    ``source`` may be a path/URL string or any object with a
    ``read(n) -> bytes`` method (8 MB AVIO buffer).
    """

    def __init__(self, source, opts: Optional[dict] = None):
        self._lib = _lib.load()
        self._h = None
        self._read_ref = None  # keeps the read callback alive
        if isinstance(source, (str, bytes)):
            url = source.encode() if isinstance(source, str) else source
            keys, vals, n = _lib.make_string_arrays(opts or {})
            self._h = self._lib.vpf_demuxer_open(url, keys, vals, n)
        elif hasattr(source, "read"):

            def read_cb(_opaque, buf, n):
                try:
                    chunk = source.read(n)
                except Exception:  # a reader's failure ends the stream
                    return 0
                if not chunk:
                    return 0
                C.memmove(buf, chunk, len(chunk))
                return len(chunk)

            self._read_ref = _lib.READ_CB(read_cb)
            self._h = self._lib.vpf_demuxer_open_reader(self._read_ref, None)
        else:
            raise TypeError(f"unsupported demuxer source: {type(source)}")
        if not self._h:
            raise RuntimeError(f"Demuxer open failed: {_lib.last_error()}")
        props = _lib.VpfStreamProps()
        self._lib.vpf_demuxer_get_props(self._h, C.byref(props))
        self._props = props
        self.last_packet_data = PacketData()

    # -- stream properties --------------------------------------------------

    @property
    def width(self) -> int:
        return self._props.width

    @property
    def height(self) -> int:
        return self._props.height

    @property
    def framerate(self) -> float:
        return self._props.frame_rate

    @property
    def avg_framerate(self) -> float:
        return self._props.avg_frame_rate

    @property
    def is_vfr(self) -> bool:
        return bool(self._props.is_vfr)

    @property
    def timebase(self) -> float:
        return self._props.time_base

    @property
    def num_frames(self) -> int:
        return self._props.num_frames

    @property
    def codec(self) -> CodecId:
        return CodecId(self._props.codec)

    @property
    def format(self) -> PixelFormat:
        return PixelFormat(self._props.pixel_format)

    @property
    def color_space(self) -> ColorSpace:
        return ColorSpace(self._props.color_space)

    @property
    def color_range(self) -> ColorRange:
        return ColorRange(self._props.color_range)

    @property
    def bit_depth(self) -> int:
        return self._props.bit_depth

    def muxing_params(self) -> MuxingParams:
        return MuxingParams(
            width=self.width, height=self.height,
            num_frames=self.num_frames, is_vfr=self.is_vfr,
            frame_rate=self.framerate, avg_frame_rate=self.avg_framerate,
            time_base=self.timebase, stream_index=self._props.stream_index,
            codec=self.codec, format=self.format,
            color_space=self.color_space, color_range=self.color_range,
        )

    def _blob(self, fn) -> bytes:
        ptr = C.POINTER(C.c_uint8)()
        size = C.c_size_t()
        fn(self._h, C.byref(ptr), C.byref(size))
        return bytes(bytearray(ptr[: size.value])) if size.value else b""

    @property
    def extradata(self) -> bytes:
        return self._blob(self._lib.vpf_demuxer_extradata)

    @property
    def annexb_extradata(self) -> bytes:
        """Parameter sets in the form of the demuxed packets (Annex.B
        start codes after the mp4toannexb filter). Handed to the decoder
        so SPS/PPS are known at open, before the first access unit's SEI
        (which precedes the in-band SPS in the filter's output)."""
        return self._blob(self._lib.vpf_demuxer_annexb_extradata)

    # -- demux / seek --------------------------------------------------------

    def demux(self, need_sei: bool = False) -> Optional[DemuxResult]:
        """Next video packet as Annex.B bytes, or None at EOF."""
        data = C.POINTER(C.c_uint8)()
        size = C.c_size_t()
        pkt = _lib.VpfPacketData()
        sei = C.POINTER(C.c_uint8)()
        sei_size = C.c_size_t()
        with trace_range("DemuxFrame"):
            r = self._lib.vpf_demuxer_demux(
                self._h, C.byref(data), C.byref(size), C.byref(pkt),
                C.byref(sei) if need_sei else None,
                C.byref(sei_size) if need_sei else None,
            )
        if r == _lib.NEED_MORE:
            return None
        if r != _lib.OK:
            raise BitstreamParserException(_lib.last_error())
        out = DemuxResult(packet=_bytes(data, size), pkt_data=_pkt_from_c(pkt))
        self.last_packet_data = out.pkt_data
        if need_sei and sei_size.value:
            out.sei = _bytes(sei, sei_size)
        return out

    def seek(self, ctx: SeekContext) -> Optional[DemuxResult]:
        """Seek and return the packet landed on (None past the end); fills
        ``ctx``'s out-fields. Raises UnseekableInputError where the input
        has no index."""
        data = C.POINTER(C.c_uint8)()
        size = C.c_size_t()
        pkt = _lib.VpfPacketData()
        out_pts = C.c_int64(-1)
        out_dur = C.c_int64(-1)
        with trace_range("DemuxSeek"):
            r = self._lib.vpf_demuxer_seek(
                self._h, ctx.seek_frame, ctx.seek_tssec,
                0 if ctx.is_by_number else 1, int(SeekMode(ctx.mode)),
                C.byref(data), C.byref(size), C.byref(pkt),
                C.byref(out_pts), C.byref(out_dur),
            )
        if r == _lib.ERR_EOF:
            return None
        if r != _lib.OK:
            msg = _lib.last_error()
            if msg.startswith(_UNSEEKABLE):
                raise UnseekableInputError(msg)
            raise RuntimeError(f"Seek failed: {msg}")
        ctx.out_frame_pts = out_pts.value
        ctx.out_frame_duration = out_dur.value
        self.last_packet_data = _pkt_from_c(pkt)
        return DemuxResult(packet=_bytes(data, size),
                           pkt_data=self.last_packet_data)

    def ts_from_time(self, sec: float) -> int:
        """Seconds → stream-timebase units, with libav's exact rounding."""
        return self._lib.vpf_demuxer_ts_from_time(self._h, sec)

    def ts_from_frame_number(self, n: int) -> int:
        return self._lib.vpf_demuxer_ts_from_frame(self._h, n)

    def flush(self) -> None:
        self._lib.vpf_demuxer_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.vpf_demuxer_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone
            pass

    def __iter__(self):
        while True:
            r = self.demux()
            if r is None:
                return
            yield r
