"""StreamMuxer — write encoded packets into a container (mp4/mkv/ts…),
over the port's build of io/native/muxer.cpp (the counterpart of the JAX
package's ``io/muxer.py``).

Beyond the reference, which writes raw elementary streams only: it
closes the container→container transcode loop. Containers verified with
the encoder's Annex.B output: mp4 (converted by libavformat's bitstream
filter) and mpeg-ts (native Annex.B). Matroska needs avcC ``extradata``
(pass it when remuxing from a source that provides it).
"""

from __future__ import annotations

import ctypes as C
from typing import Optional, Union

import numpy as np

from ..core.enums import CodecId
from ..core.packet import PacketData
from . import _lib

AV_NOPTS = -(2**63)


class StreamMuxer:
    """Mux one video stream. Timestamps are in 1/fps units (frame index
    granularity, as the encoder assigns them by default)."""

    def __init__(self, url: str, codec: CodecId, width: int, height: int,
                 fps: float = 30.0, format: Optional[str] = None,
                 extradata: bytes = b""):
        self._lib = _lib.load()
        self._h = None
        if abs(fps - round(fps)) > 1e-6:
            fps_num, fps_den = int(round(fps * 1001)), 1001
        else:
            fps_num, fps_den = int(round(fps)), 1
        extra = ((C.c_uint8 * len(extradata)).from_buffer_copy(extradata)
                 if extradata else None)
        self._h = self._lib.vpf_muxer_open(
            str(url).encode(), (format or "").encode(), int(codec), width,
            height, fps_num, fps_den,
            C.cast(extra, C.POINTER(C.c_uint8)) if extra else None,
            len(extradata))
        if not self._h:
            raise RuntimeError(f"muxer open failed: {_lib.last_error()}")

    def write(self, packet: Union[np.ndarray, bytes],
              pkt_data: Optional[PacketData] = None,
              pts: Optional[int] = None) -> None:
        """Write one packet; its timestamps and key flag come from
        ``pkt_data``, else ``pts`` (default 0) as a key frame."""
        if isinstance(packet, (bytes, bytearray)):
            buf = np.frombuffer(bytes(packet), np.uint8)
        else:
            buf = np.ascontiguousarray(packet, np.uint8)
        if pkt_data is not None:
            p, d, k = pkt_data.pts, pkt_data.dts, pkt_data.key
        else:
            p, d, k = (pts if pts is not None else 0), AV_NOPTS, 1
        r = self._lib.vpf_muxer_write(
            self._h, buf.ctypes.data_as(C.POINTER(C.c_uint8)), buf.nbytes,
            p, d, int(bool(k)))
        if r != _lib.OK:
            raise RuntimeError(_lib.last_error())

    def close(self) -> None:
        """Write the trailer and close the file."""
        if self._h:
            self._lib.vpf_muxer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone
            pass
