"""Video decoding: the codec session and the reader — the counterpart of
the JAX package's ``io/decoder.py`` over the port's own build of the
native decoder (io/native/decoder.cpp).

* :class:`VideoDecoder` wraps one codec session: feed packets, drain
  frames, flush, reset, re-create.
* :class:`VideoReader` demuxes and decodes a file or URL, or decodes
  packets it is given; it seeks, returns SEI and packet metadata, and
  raises the typed errors of :mod:`..core.exceptions`. Frames come back
  on the host (:class:`DecodedFrame`) or as a device ``Surface`` (CUDA by
  default).

A frame-number or time seek that lands past the end resets the decoder
before it returns None, so decoding on after it yields no frame from
before the seek (the JAX package returns without the reset).
"""

from __future__ import annotations

import ctypes as C
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import geometry
from ..core.enums import CodecId, ColorRange, ColorSpace, PixelFormat, SeekMode
from ..core.exceptions import BitstreamParserException, HwResetException
from ..core.packet import PacketData, SeekContext
from ..core.surface import Surface
from ..utils.tracing import trace_range
from . import _lib
from .demuxer import FFmpegDemuxer

_NO_DEMUXER_MSG = (
    "Tried to call DecodeSurface/DecodeFrame on a Decoder that has been "
    "initialized without a built-in demuxer. Please use "
    "DecodeSurfaceFromPacket/DecodeFrameFromPacket instead or intialize the "
    "decoder with a demuxer when decoding from a file"
)

AV_NOPTS_VALUE = -(2**63)

_MV_DTYPE = np.dtype([
    ("source", np.int32), ("w", np.uint8), ("h", np.uint8),
    ("src_x", np.int16), ("src_y", np.int16), ("dst_x", np.int16),
    ("dst_y", np.int16), ("flags", np.uint64), ("motion_x", np.int32),
    ("motion_y", np.int32), ("motion_scale", np.uint16),
])


@dataclass
class DecodedFrame:
    """One decoded frame, packed tight in ``format`` layout."""

    data: np.ndarray  # packed bytes, dtype uint8
    width: int
    height: int
    format: PixelFormat
    color_space: ColorSpace
    color_range: ColorRange
    pkt_data: PacketData

    def _host(self) -> Surface:
        return Surface.from_host_frame(self.data, self.format, self.width,
                                       self.height)

    def planes(self):
        return self._host().planes

    def to_surface(self, device=None) -> Surface:
        """The frame as a device Surface (CUDA by default; ``"cpu"`` gives
        torch tensors on the CPU)."""
        return self._host().to_device(device)


def _raise_for(lib, h, r: int) -> None:
    """Typed error for a native decode status that is not a frame."""
    if r == _lib.ERR_PARSE:
        raise BitstreamParserException(_lib.last_error())
    if r == _lib.ERR_DECODE:
        # host analog of the reference's decoder re-creation on HW error
        lib.vpf_decoder_recreate(h)
        raise HwResetException(_lib.last_error())
    raise RuntimeError(_lib.last_error())


class VideoDecoder:
    """One codec session. Thread-safe across instances, not within one."""

    def __init__(self, codec: CodecId, extradata: bytes = b"",
                 threads: int = 0, export_mvs: bool = False,
                 output_format: Optional[PixelFormat] = None):
        self._lib = _lib.load()
        self._h = None
        extra = ((C.c_uint8 * len(extradata)).from_buffer_copy(extradata)
                 if extradata else None)
        self._h = self._lib.vpf_decoder_create(
            int(codec), C.cast(extra, C.POINTER(C.c_uint8)) if extra else None,
            len(extradata), threads, 1 if export_mvs else 0,
        )
        if not self._h:
            raise RuntimeError(f"Decoder create failed: {_lib.last_error()}")
        self.codec = CodecId(codec)
        self.output_format = output_format  # None = native layout

    def _grab_frame(self, out: Optional[np.ndarray] = None) -> DecodedFrame:
        desc = _lib.VpfFrameDesc()
        if self._lib.vpf_decoder_frame_desc(self._h, C.byref(desc)) != _lib.OK:
            raise RuntimeError(_lib.last_error())
        fmt = (self.output_format if self.output_format is not None
               else PixelFormat(desc.pixel_format))
        size = geometry.host_frame_size(fmt, desc.width, desc.height)
        if out is not None:
            buf = out.reshape(-1).view(np.uint8)
            if buf.nbytes != size:
                raise ValueError(
                    f"out buffer is {buf.nbytes} bytes, frame needs {size}")
        else:
            buf = np.empty(size, dtype=np.uint8)
        r = self._lib.vpf_decoder_copy_frame(
            self._h, int(fmt), buf.ctypes.data_as(C.POINTER(C.c_uint8)),
            buf.nbytes)
        if r != _lib.OK:
            raise RuntimeError(_lib.last_error())
        p = desc.pkt
        return DecodedFrame(
            data=buf, width=desc.width, height=desc.height, format=fmt,
            color_space=ColorSpace(desc.color_space),
            color_range=ColorRange(desc.color_range),
            pkt_data=PacketData(key=p.key, pts=p.pts, dts=p.dts, pos=p.pos,
                                bsl=p.bsl, duration=p.duration),
        )

    def decode_packet(self, packet: Optional[np.ndarray],
                      pkt_data: Optional[PacketData] = None,
                      out: Optional[np.ndarray] = None
                      ) -> Optional[DecodedFrame]:
        """Feed one Annex.B packet (None = begin the EOS flush); return a
        frame if one is ready. ``out``: an optional packed destination
        (uint8, the exact frame size) the decoder writes straight into."""
        ptr, size = None, 0
        if packet is not None and len(packet):
            packet = np.ascontiguousarray(packet, dtype=np.uint8)
            ptr = packet.ctypes.data_as(C.POINTER(C.c_uint8))
            size = packet.nbytes
        cpkt = None
        if pkt_data is not None:
            cpkt = _lib.VpfPacketData(
                key=pkt_data.key, pts=pkt_data.pts, dts=pkt_data.dts,
                pos=pkt_data.pos, bsl=pkt_data.bsl,
                duration=pkt_data.duration)
        with trace_range("DecodeFrame"):
            r = self._lib.vpf_decoder_decode(
                self._h, ptr, size, C.byref(cpkt) if cpkt else None)
        if r == _lib.OK:
            return self._grab_frame(out)
        if r in (_lib.NEED_MORE, _lib.ERR_EOF):
            return None
        _raise_for(self._lib, self._h, r)

    def flush_frame(self, out: Optional[np.ndarray] = None
                    ) -> Optional[DecodedFrame]:
        r = self._lib.vpf_decoder_flush_frame(self._h)
        if r == _lib.OK:
            return self._grab_frame(out)
        if r in (_lib.NEED_MORE, _lib.ERR_EOF):
            return None
        _raise_for(self._lib, self._h, r)

    def reset(self) -> None:
        """Discard codec state without EOS (for seeks)."""
        self._lib.vpf_decoder_reset(self._h)

    def motion_vectors(self) -> np.ndarray:
        """Motion vectors of the last decoded frame as a structured
        array (needs ``export_mvs=True``)."""
        count = C.c_size_t()
        self._lib.vpf_decoder_motion_vectors(self._h, None, 0, C.byref(count))
        n = count.value
        if n == 0:
            return np.empty(0, dtype=_MV_DTYPE)
        arr = (_lib.VpfMotionVector * n)()
        self._lib.vpf_decoder_motion_vectors(self._h, arr, n, C.byref(count))
        return np.array(
            [tuple(getattr(mv, f) for f in _MV_DTYPE.names) for mv in arr],
            dtype=_MV_DTYPE)

    def close(self) -> None:
        if self._h:
            self._lib.vpf_decoder_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone
            pass


class VideoReader:
    """Demux + decode from a file/URL, or decode the packets it is given
    (``codec=`` with no source)."""

    def __init__(self, source: Optional[str] = None,
                 opts: Optional[dict] = None, *,
                 codec: Optional[CodecId] = None, width: int = 0,
                 height: int = 0, format: PixelFormat = PixelFormat.NV12,
                 threads: int = 0, device=None, export_mvs: bool = False):
        self.device = device
        self.format = format
        self._last_pkt_data: Optional[PacketData] = None
        self._last_sei: Optional[np.ndarray] = None
        if source is not None:
            self.demuxer: Optional[FFmpegDemuxer] = FFmpegDemuxer(source, opts)
            self.decoder = VideoDecoder(
                self.demuxer.codec, threads=threads,
                extradata=self.demuxer.annexb_extradata,
                export_mvs=export_mvs,
            )
            self.format = self.demuxer.format
        else:
            if codec is None:
                raise ValueError("standalone decoder needs codec=")
            self.demuxer = None
            self.decoder = VideoDecoder(codec, threads=threads,
                                        export_mvs=export_mvs)
            self._standalone_wh = (width, height)

    def motion_vectors(self) -> np.ndarray:
        return self.decoder.motion_vectors()

    # -- properties (the reference's error contract without a demuxer) -----

    def _need_demuxer(self, what: str) -> FFmpegDemuxer:
        if not self.demuxer:
            raise RuntimeError(
                "Decoder was created without built-in demuxer support. "
                f"Please get {what} from demuxer instead")
        return self.demuxer

    def width(self) -> int:
        return self._need_demuxer("width").width

    def height(self) -> int:
        return self._need_demuxer("height").height

    def color_space(self) -> ColorSpace:
        return self._need_demuxer("color space").color_space

    def color_range(self) -> ColorRange:
        return self._need_demuxer("color range").color_range

    def framerate(self) -> float:
        return self._need_demuxer("framerate").framerate

    def avg_framerate(self) -> float:
        return self._need_demuxer("avg framerate").avg_framerate

    def is_vfr(self) -> bool:
        return self._need_demuxer("variable framerate flag").is_vfr

    def timebase(self) -> float:
        return self._need_demuxer("timebase").timebase

    def num_frames(self) -> int:
        return self._need_demuxer("number of frames").num_frames

    def frame_size(self) -> int:
        d = self._need_demuxer("frame size")
        return geometry.host_frame_size(self.format, d.width, d.height)

    def last_packet_data(self) -> PacketData:
        self._need_demuxer("packet data")
        return self._last_pkt_data or PacketData()

    def last_sei(self) -> Optional[np.ndarray]:
        return self._last_sei

    # -- decode core --------------------------------------------------------

    def decode(self, *, packet: Optional[np.ndarray] = None,
               packet_data: Optional[PacketData] = None,
               seek_ctx: Optional[SeekContext] = None,
               need_sei: bool = False, flush: bool = False,
               out: Optional[np.ndarray] = None) -> Optional[DecodedFrame]:
        """One decode step; returns a frame or None (EOF).

        * built-in demux: demux until the decoder yields a frame or EOF;
        * ``seek_ctx`` (PREV_KEY_FRAME only): seek the demuxer, reset the
          decoder, then decode until frame.pts ≥ the target (counting
          ``num_frames_decoded``). A refused seek raises
          UnseekableInputError with both sessions untouched; a seek past
          the end resets the decoder and returns None;
        * standalone: feed ``packet`` (with optional ``packet_data``);
        * ``flush``: drain one frame (EOS).
        """
        if flush:
            return self.decoder.flush_frame(out=out)
        if packet is not None:
            return self.decoder.decode_packet(packet, packet_data, out=out)
        demuxer = self.demuxer
        if demuxer is None:
            raise RuntimeError(_NO_DEMUXER_MSG)

        target_pts = None
        pending = None
        if seek_ctx is not None and seek_ctx.use_seek:
            if seek_ctx.mode != SeekMode.PREV_KEY_FRAME:
                raise RuntimeError(
                    "Decoder can only seek to closest previous key frame")
            # the demuxer first: a refusal raises before the decoder is
            # touched, so the session stays where it was
            pending = demuxer.seek(seek_ctx)
            self.decoder.reset()
            if pending is None:
                return None
            if seek_ctx.is_by_number:
                target_pts = demuxer.ts_from_frame_number(seek_ctx.seek_frame)
            else:
                target_pts = demuxer.ts_from_time(seek_ctx.seek_tssec)
            seek_ctx.num_frames_decoded = 0
            seek_ctx.use_seek = False

        while True:
            if pending is not None:
                res, pending = pending, None
            else:
                res = demuxer.demux(need_sei=need_sei)
            if res is None:
                frame = self.decoder.flush_frame(out=out)
            else:
                self._last_pkt_data = res.pkt_data
                if need_sei:
                    self._last_sei = res.sei
                frame = self.decoder.decode_packet(res.packet, res.pkt_data,
                                                   out=out)
            if frame is None:
                if res is None:
                    return None  # fully drained
                continue  # still priming
            if target_pts is not None:
                seek_ctx.num_frames_decoded += 1
                if frame.pkt_data.pts == AV_NOPTS_VALUE:
                    raise RuntimeError(
                        "Decoded frame doesn't have PTS, can't seek.")
                if frame.pkt_data.pts < target_pts:
                    continue
                seek_ctx.out_frame_pts = frame.pkt_data.pts
                seek_ctx.out_frame_duration = frame.pkt_data.duration
            return frame

    # -- convenience wrappers ------------------------------------------------

    def decode_single_frame(self, **kw) -> Optional[DecodedFrame]:
        return self.decode(**kw)

    def decode_single_surface(self, **kw) -> Optional[Surface]:
        frame = self.decode(**kw)
        if frame is None:
            return None
        with trace_range("UploadSurface"):
            return frame.to_surface(self.device or _default_device())

    def flush_single_frame(self) -> Optional[DecodedFrame]:
        return self.decode(flush=True)

    def flush_single_surface(self) -> Optional[Surface]:
        frame = self.decode(flush=True)
        if frame is None:
            return None
        return frame.to_surface(self.device or _default_device())

    def frames(self, need_sei: bool = False):
        """Iterate all frames including the drain tail."""
        while True:
            f = self.decode(need_sei=need_sei)
            if f is None:
                return
            yield f


def _default_device() -> torch.device:
    return torch.device("cuda")


def codec_caps(codec: CodecId, *, encoder: bool = False) -> dict:
    """Capabilities of a codec through libav (``vpf_codec_caps``), as a
    dict of the VpfCodecCaps fields."""
    lib = _lib.load()
    caps = _lib.VpfCodecCaps()
    if lib.vpf_codec_caps(int(codec), 1 if encoder else 0,
                          C.byref(caps)) != _lib.OK:
        raise ValueError(_lib.last_error())
    return {name: int(getattr(caps, name)) for name, _ in caps._fields_}
