"""VideoEncoder — the software encode session with the reference's
options vocabulary and session semantics, over the port's build of
io/native/encoder.cpp (the counterpart of the JAX package's
``io/encoder.py``), and :func:`make_clip` for synthetic test clips.

Parity target: PyNvEncoder (src/PyNvCodec/src/PyNvEncoder.cpp): dict
options validated against the 29-key vocabulary, frame size from 's',
lazy session creation at the first encode (so the sync flag can shape
the session), the delayed-output FIFO, SEI, Flush/FlushSinglePacket and
Reconfigure(force_idr, reset).

Input frames are packed host bytes or a ``Surface``; a CUDA Surface is
downloaded by one copy the host waits for before the encoder reads it.
"""

from __future__ import annotations

import ctypes as C
import pathlib
from typing import Optional, Union

import numpy as np

from ..core import geometry
from ..core.enums import PixelFormat
from ..core.exceptions import EncoderException
from ..core.packet import PacketData
from ..core.surface import Surface
from ..utils.tracing import trace_range
from . import _lib

#: the reference's option vocabulary (NvCodecCliOptions.cpp:46-83)
ENCODER_OPTIONS = {
    "codec": "video codec: {'codec' : 'h264'}",
    "preset": "encode preset: {'preset' : 'P4'}",
    "tuning_info": "how to tune the encoder: {'tuning_info' : 'high_quality'}",
    "profile": "h.264 profile: {'profile' : 'high'}",
    "max_res": "max resolution: {'max_res' : '3840x2160'}",
    "s": "video frame size: {'s' : '1920x1080'}",
    "fps": "video fps: {'fps' : '30'}",
    "bf": "number of b frames: {'bf' : '3'}",
    "gop": "gop size: {'gop' : '30'}",
    "bitrate": "bitrate: {'bitrate' : '10M'}",
    "multipass": "multi-pass encoding: {'multipass' : 'fullres'}",
    "ldkfs": "low-delay key frame scale: {'ldkfs' : ''}",
    "maxbitrate": "max bitrate: {'maxbitrate' : '20M'}",
    "vbvbufsize": "vbv buffer size: {'vbvbufsize' : '10M'}",
    "vbvinit": "init vbv buffer size: {'vbvinit' : '10M'}",
    "cq": "cq parameter: {'cq' : ''}",
    "rc": "rc mode: {'rc' : 'cbr'}",
    "initqp": "initial qp parameter value: {'initqp' : '32'}",
    "qmin": "minimum qp: {'qmin' : '28'}",
    "qmax": "maximum qp: {'qmax' : '36'}",
    "constqp": "const qp mode: {'constqp' : ''}",
    "temporalaq": "temporal adaptive quantization: {'temporalaq' : ''}",
    "lookahead": "look ahead encoding: {'lookahead' : '8'}",
    "aq": "adaptive quantization: {'aq' : ''}",
    "fmt": "pixel format: {'fmt' : 'YUV444'}",
    "idrperiod": "distance between I frames: {'idrperiod' : '256'}",
    "numrefl0": "number of ref frames in l0 list: {'numrefl0' : '4'}",
    "numrefl1": "number of ref frames in l1 list: {'numrefl1' : '4'}",
    "repeatspspps": "write SPS/PPS for every IDR frame: {'repeatspspps' : '0'}",
}

# the reference's input formats (PyNvEncoder.cpp:204-221): NV12, YUV444,
# 10-bit 4:2:0 and 4:4:4; plus planar YUV420, 4:2:2 and 12-bit gray
_INPUT_FORMATS = (
    PixelFormat.NV12, PixelFormat.YUV420, PixelFormat.YUV422,
    PixelFormat.YUV444, PixelFormat.P10, PixelFormat.P12,
    PixelFormat.YUV420_10bit, PixelFormat.YUV444_10bit, PixelFormat.GRAY12,
)

_u8p = C.POINTER(C.c_uint8)


def get_encoder_params() -> dict:
    """GetNvencParams analog (PyNvCodec.cpp:431-433)."""
    return dict(ENCODER_OPTIONS)


def _checked_opts(opts: dict) -> dict:
    out = {str(k): str(v) for k, v in opts.items()}
    for k in out:
        if k not in ENCODER_OPTIONS:
            raise ValueError(
                f'Invalid parameter name"{k}" for NvEncoderClInterface')
    return out


def _frame_size(s: str) -> tuple[int, int]:
    try:
        w, h = s.split("x")
        return int(w), int(h)
    except ValueError:
        raise ValueError(f"Invalid frame size option 's': {s!r}") from None


class VideoEncoder:
    """Encode packed frames / Surfaces into an elementary stream.

    ``device`` is accepted for the reference's signature and not used:
    the encoder runs on the host.
    """

    def __init__(self, opts: dict, device=None):
        self._lib = _lib.load()
        self.opts = _checked_opts(opts)
        self._width, self._height = _frame_size(self.opts.get("s", ""))
        fmt = self.opts.get("fmt", "NV12")
        by_name = {m.name.upper(): m for m in PixelFormat}
        self.format = by_name.get(fmt.upper())
        if self.format not in _INPUT_FORMATS:
            raise ValueError(f"Unsupported encoder input format: {fmt}")
        if self.format == PixelFormat.YUV420_10bit:
            self.format = PixelFormat.P10  # the packed wire format is P010
        self.device = device
        self._h = None  # lazy: the first encode knows the sync flag
        self._sync = False
        self._frames_in = 0

    @property
    def width(self) -> int:
        return self._width

    @property
    def height(self) -> int:
        return self._height

    def frame_size_in_bytes(self) -> int:
        return geometry.host_frame_size(self.format, self._width,
                                        self._height)

    def _ensure_session(self, sync: bool) -> None:
        if self._h:
            return
        self._sync = sync
        keys, vals, n = _lib.make_string_arrays(self.opts)
        self._h = self._lib.vpf_encoder_create(keys, vals, n, 1 if sync else 0)
        if not self._h:
            raise EncoderException(
                f"Encoder create failed: {_lib.last_error()}")

    def _take_packet(self) -> tuple[np.ndarray, PacketData]:
        data = _u8p()
        size = C.c_size_t()
        meta = _lib.VpfPacketData()
        self._lib.vpf_encoder_packet(self._h, C.byref(data), C.byref(size),
                                     C.byref(meta))
        pkt = np.ctypeslib.as_array(data, shape=(size.value,)).copy()
        return pkt, PacketData(key=meta.key, pts=meta.pts, dts=meta.dts,
                               pos=meta.pos, bsl=size.value,
                               duration=meta.duration)

    def _host_bytes(self, frame) -> np.ndarray:
        if isinstance(frame, Surface):
            if (frame.width, frame.height) != (self._width, self._height):
                raise ValueError(
                    f"Surface size {frame.width}x{frame.height} != encoder "
                    f"size {self._width}x{self._height}")
            if frame.format != self.format:
                raise ValueError(
                    f"Surface format {frame.format.name} != encoder input "
                    f"format {self.format.name}")
            return frame.download()
        buf = np.ascontiguousarray(frame).reshape(-1).view(np.uint8)
        if buf.nbytes != self.frame_size_in_bytes():
            raise ValueError(f"frame has {buf.nbytes} bytes, expected "
                             f"{self.frame_size_in_bytes()}")
        return buf

    def encode(self, frame: Union[np.ndarray, Surface, None],
               sei: Optional[bytes] = None, sync: bool = False,
               pts: int = -1) -> Optional[tuple[np.ndarray, PacketData]]:
        """Encode one frame (packed bytes or a Surface); None is a flush
        step.

        Returns (packet, meta) when a packet is ready, else None (output
        delay). With ``sync=True`` the session is built zero-delay so
        every frame yields its packet at once.
        """
        self._ensure_session(sync)
        if frame is None:
            return self.flush_single_packet()
        buf = self._host_bytes(frame)
        sei_arr = (np.frombuffer(bytes(sei), dtype=np.uint8)
                   if sei is not None and len(sei) else None)
        with trace_range("EncodeFrame"):
            r = self._lib.vpf_encoder_encode(
                self._h, buf.ctypes.data_as(_u8p), buf.nbytes,
                None if sei_arr is None else sei_arr.ctypes.data_as(_u8p),
                0 if sei_arr is None else sei_arr.nbytes,
                pts if pts >= 0 else self._frames_in)
        self._frames_in += 1
        if r == _lib.OK:
            return self._take_packet()
        if r == _lib.NEED_MORE:
            return None
        raise EncoderException(_lib.last_error())

    def flush_single_packet(self) -> Optional[tuple[np.ndarray, PacketData]]:
        """Drain one packet after EOS; None when fully drained."""
        self._ensure_session(self._sync)
        r = self._lib.vpf_encoder_encode(self._h, None, 0, None, 0, -1)
        if r == _lib.OK:
            return self._take_packet()
        if r in (_lib.NEED_MORE, _lib.ERR_EOF):
            return None
        raise EncoderException(_lib.last_error())

    def flush(self) -> list[tuple[np.ndarray, PacketData]]:
        out = []
        while True:
            pkt = self.flush_single_packet()
            if pkt is None:
                return out
            out.append(pkt)

    def reconfigure(self, opts: dict, force_idr: bool = False,
                    reset_encoder: bool = False) -> bool:
        """Update options; optionally force the next IDR or rebuild the
        session (reference: PyNvEncoder::Reconfigure, Tasks.cpp:146-158)."""
        new = _checked_opts(opts)
        self.opts.update(new)
        if "s" in new:
            self._width, self._height = _frame_size(new["s"])
        if self._h is None:
            return True  # no session yet: the options apply at its build
        keys, vals, n = _lib.make_string_arrays(new)
        r = self._lib.vpf_encoder_reconfigure(
            self._h, keys, vals, n, 1 if force_idr else 0,
            1 if reset_encoder else 0)
        if r != _lib.OK:
            raise EncoderException(_lib.last_error())
        return True

    def close(self) -> None:
        if self._h:
            self._lib.vpf_encoder_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone
            pass


def make_clip(path, width: int, height: int, frames: int,
              codec: str = "h264", level: Optional[int] = None
              ) -> pathlib.Path:
    """Encode a moving-gradient NV12 clip (the pattern of the JAX
    package's bench clip) into an elementary stream at ``path``. With
    ``level`` the luma pattern is a quarter of the range wide, from
    ``level`` up, so clips made at different levels are told apart by
    their brightness."""
    enc = VideoEncoder({"codec": codec, "preset": "P1",
                        "s": f"{width}x{height}", "bitrate": "8M",
                        "fps": "30", "gop": "30"})
    ys = np.arange(height, dtype=np.uint16)[:, None]
    xs = np.arange(width, dtype=np.uint16)[None, :]
    stream = bytearray()
    try:
        for i in range(frames):
            y = ((ys * 2 + xs + i * 7) % 256).astype(np.uint8)
            if level is not None:
                y = y // 4 + np.uint8(level)
            uv = np.full((height // 2, width), 110 + (i % 40), np.uint8)
            out = enc.encode(np.concatenate([y.ravel(), uv.ravel()]), pts=i)
            if out is not None:
                stream += out[0].tobytes()
        for pkt, _ in enc.flush():
            stream += pkt.tobytes()
    finally:
        enc.close()
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bytes(stream))
    return path
