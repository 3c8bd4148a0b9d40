"""Overlapped transcode: native decode worker(s) + encoder (the
counterpart of the JAX package's ``io/transcode.py``).

The reference's transcode loop is serial per frame: decode, then encode,
on the caller's thread (samples/SampleMeasureVideoQuality.py). Here the
decode side runs in the :class:`~.pool.NativeDecodePool`'s C++ worker
thread, which never holds the GIL, so the encoder consumes batch *i*
while the worker decodes batch *i+1*.

:func:`transcode_many` fans N independent streams across a thread pool
(stream per thread, the SampleDecodeMultiThread / SampleEncodeMultiThread
model). Transcoding is host work: frames never go to a device, so the
decode pool is built for the CPU.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.enums import PixelFormat
from ..utils.tracing import StageTimer
from .demuxer import FFmpegDemuxer
from .encoder import VideoEncoder
from .pool import NativeDecodePool


@dataclass
class TranscodeStats:
    frames: int = 0
    wall_s: float = 0.0
    out_bytes: int = 0
    per_stream_fps: list = field(default_factory=list)
    streams: Optional[list] = None  # the bitstreams, when kept

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s else 0.0


class Transcoder:
    """Decode one stream → re-encode, decode overlapped with encode.

    ``enc_opts`` override the encoder defaults; ``s``/``fps``/``fmt`` are
    filled from the probed source when absent. Output geometry other than
    the source's needs a device resize: ``ops.fused.encode_feed``.
    """

    def __init__(self, source: str, enc_opts: Optional[dict] = None,
                 batch_size: int = 4, n_buffers: int = 4,
                 max_frames: int = 0):
        probe = FFmpegDemuxer(source)
        try:
            self.width, self.height = probe.width, probe.height
            fps = probe.framerate or 30.0
        finally:
            probe.close()
        opts = {"codec": "h264", "preset": "P1", "fmt": "YUV420",
                "s": f"{self.width}x{self.height}", "fps": f"{fps:g}",
                "gop": "30", "bitrate": "8M"}
        opts.update(enc_opts or {})
        if opts.get("fmt") != "YUV420":
            raise ValueError(
                "Transcoder feeds packed planar YUV420 (the decode-pool "
                f"layout); got fmt={opts.get('fmt')!r}")
        self.enc_opts = opts
        self.encoder = VideoEncoder(opts)
        self.pool = NativeDecodePool(
            [source], batch_size=batch_size, out_format=PixelFormat.YUV420,
            max_frames_per_stream=max_frames, n_buffers=n_buffers,
            device="cpu")
        # acquire = waiting on the decode worker; encode = the encoder on
        # the caller's thread (usually the bottleneck)
        self.timer = StageTimer("transcode")

    def run(self, on_packet: Optional[Callable[[np.ndarray, object], None]]
            = None) -> TranscodeStats:
        """Pump the whole stream. ``on_packet(data, pkt_data)`` receives
        every encoded packet (by default packets are counted and
        dropped)."""
        st = TranscodeStats()
        enc = self.encoder
        t0 = time.perf_counter()

        def emit(out):
            if out is None:
                return
            data, meta = out
            st.out_bytes += data.nbytes
            if on_packet is not None:
                on_packet(data, meta)

        try:
            while True:
                with self.timer.measure("acquire"):
                    batch = self.pool.acquire()
                if batch is None:
                    break
                try:
                    with self.timer.measure("encode"):
                        for frame in batch:
                            emit(enc.encode(frame))
                            st.frames += 1
                finally:
                    self.pool.release()  # never leak the held ring slot
            for out in enc.flush():
                emit(out)
            st.wall_s = time.perf_counter() - t0
            return st
        finally:
            # on any exit (an encoder or on_packet failure included) stop
            # the native decode workers
            self.pool.close()


def transcode(source: str, enc_opts: Optional[dict] = None,
              max_frames: int = 0) -> tuple[bytes, TranscodeStats]:
    """One-call transcode → (elementary stream bytes, stats)."""
    out = bytearray()
    t = Transcoder(source, enc_opts, max_frames=max_frames)
    stats = t.run(lambda data, meta: out.extend(data.tobytes()))
    return bytes(out), stats


def transcode_many(sources: Sequence[str], enc_opts: Optional[dict] = None,
                   max_frames: int = 0,
                   keep_streams: bool = False) -> TranscodeStats:
    """Stream-per-thread aggregate transcode (N decode workers + N
    encoders). The native calls release the GIL, so threads scale with
    cores; the wall clock spans the whole fan-out."""
    outs: list = [None] * len(sources)

    def one(idx_src):
        idx, src = idx_src
        t = Transcoder(src, enc_opts, max_frames=max_frames)
        if not keep_streams:
            return t.run()
        buf = bytearray()
        st = t.run(lambda d, m: buf.extend(d.tobytes()))
        outs[idx] = bytes(buf)
        return st

    agg = TranscodeStats()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        results = list(ex.map(one, enumerate(sources)))
    agg.wall_s = time.perf_counter() - t0
    for st in results:
        agg.frames += st.frames
        agg.out_bytes += st.out_bytes
        agg.per_stream_fps.append(round(st.fps, 1))
    if keep_streams:
        agg.streams = outs
    return agg
