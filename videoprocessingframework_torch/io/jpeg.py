"""The split MJPEG codec: host entropy coding, device pixels — the
counterpart of the JAX package's ``io/jpeg.py``.

* :class:`JpegCoefDecoder` runs the serial Huffman decode on the host
  (``io/native/jpeg.cpp`` in ``libvpf_jpeg``, which needs no libav) and
  emits quantized DCT coefficients; :class:`JpegCoefEncoder` packs them
  back into baseline JFIF.
* :class:`~..ops.jpeg.JpegDevicePipeline` (dequant + IDCT + reassembly,
  then the fused resize + CSC), :class:`~..ops.jpeg.JpegDeviceEncoder`
  and :class:`~..ops.jpeg.JpegDeviceTranscoder` run everything on the
  far side of the coefficients on the device.

:class:`MjpegReader`, :class:`MjpegWriter` and :class:`MjpegTranscoder`
tie them to streams. Baseline (SOF0/1) and progressive (SOF2) streams
decode through the split path; streams it cannot take (12-bit,
hierarchical / arithmetic, other sampling) raise :class:`JpegStreamError`
and decode through :class:`~.decoder.VideoReader` instead. Demuxing a
container (the reader, the transcoder) and muxing one (the writer with
``container=``) need the libav runtime; the coders and the raw writer do
not.
"""

from __future__ import annotations

import ctypes as C
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..core.enums import CodecId
from ..utils.device import resolve_device, upload
from . import _jpeg_lib as _lib

__all__ = [
    "JpegStreamError",
    "JpegCoefDecoder",
    "JpegCoefEncoder",
    "MjpegReader",
    "MjpegWriter",
    "MjpegTranscoder",
]


class JpegStreamError(RuntimeError):
    """Stream outside the device path's scope (12-bit, hierarchical /
    arithmetic, sampling > 2). Fall back to VideoReader."""


def _snapshot(info: _lib.VpfJpegInfo) -> SimpleNamespace:
    """Plain-Python copy of the probe fields the device classes read:
    safe to hand across threads (a decoder reuses its ctypes struct) and
    cheap to compare."""
    n = int(info.ncomp)
    return SimpleNamespace(
        ncomp=n,
        width=int(info.width),
        height=int(info.height),
        hs=[int(info.hs[c]) for c in range(n)],
        vs=[int(info.vs[c]) for c in range(n)],
        bh=[int(info.bh[c]) for c in range(n)],
        bw=[int(info.bw[c]) for c in range(n)],
        qt=[tuple(info.qt[c][:64]) for c in range(n)],
        restart_interval=int(info.restart_interval),
        progressive=bool(info.progressive),
    )


def _geo_key(snap) -> tuple:
    """Everything that changes the block layout or the crop: dims,
    component count, sampling factors (coefficient shapes alone miss a
    dims change inside the same MCU grid)."""
    return (snap.width, snap.height, snap.ncomp, tuple(snap.hs),
            tuple(snap.vs))


def _bounded_ordered_map(fn, items, workers: int, depth: int = 4):
    """``map(fn, items)`` over a thread pool, yielding in order with at
    most ``workers * depth`` tasks in flight (``Executor.map`` would
    consume the whole packet iterator up front)."""
    with ThreadPoolExecutor(max_workers=workers) as ex:
        window: deque = deque()
        it = iter(items)
        try:
            while True:
                while len(window) < workers * depth:
                    window.append(ex.submit(fn, next(it)))
                yield window.popleft().result()
        except StopIteration:
            pass
        while window:
            yield window.popleft().result()


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, np.uint8)
    return np.ascontiguousarray(data).view(np.uint8).reshape(-1)


def _host_i16(c) -> np.ndarray:
    """A coefficient batch (numpy or a tensor on any device) as a
    contiguous int16 host array."""
    if isinstance(c, torch.Tensor):
        c = c.cpu().numpy()
    return np.ascontiguousarray(c, np.int16)


def _coef_ring(snap, batch: int, pin: bool = False) -> tuple:
    """Per-component [batch, blocks, 64] int16 tensors for a stream's
    block grid (pinned for a CUDA upload)."""
    return tuple(torch.zeros((batch, int(snap.bh[c]) * int(snap.bw[c]), 64),
                             dtype=torch.int16, pin_memory=pin)
                 for c in range(int(snap.ncomp)))


class JpegCoefDecoder:
    """Entropy-decode JPEG images to zigzag DCT coefficients.

    Stateful per stream: geometry and quant tables are captured at the
    first :meth:`decode` (or :meth:`probe`) and the coefficient buffers
    allocated once; a mid-stream geometry change re-probes and
    reallocates (the native layer refuses to write past a buffer's
    capacity). ``quant_dirty`` is set when a decode changed the tables.

    ``decode`` returns per-component int16 ``[blocks, 64]`` arrays in
    zigzag order; batches of them feed ``JpegDevicePipeline``. One
    decoder per thread: its ctypes struct is reused per call.
    """

    def __init__(self):
        self._lib = _lib.load()
        self.info: Optional[_lib.VpfJpegInfo] = None
        self._bufs: list = []
        self.quant_dirty = False

    def probe(self, data) -> _lib.VpfJpegInfo:
        """Parse the headers only (through SOS) and adopt them: geometry
        and quant tables."""
        info = self.peek(data)
        self._adopt(info)
        return info

    def peek(self, data) -> _lib.VpfJpegInfo:
        """Header-only parse without adopting it (no reallocation, no
        state change): lets callers see a geometry or table change before
        decoding into preallocated buffers."""
        a = _as_u8(data)
        info = _lib.VpfJpegInfo()
        rc = self._lib.vpf_jpeg_probe(a.ctypes.data_as(_lib.u8p), a.size,
                                      C.byref(info))
        if rc != _lib.OK:
            raise JpegStreamError(_lib.last_error())
        return info

    def _adopt(self, info: _lib.VpfJpegInfo) -> None:
        old = self.info
        self.info = info
        n = int(info.ncomp)
        self._bufs = [np.zeros((int(info.bh[c]) * int(info.bw[c]), 64),
                               np.int16) for c in range(n)]
        if old is not None and any(bytes(old.qt[c]) != bytes(info.qt[c])
                                   for c in range(n)):
            self.quant_dirty = True

    def _parse_into(self, a: np.ndarray, get_bufs):
        """The native parse, writing straight into the arrays ``get_bufs()``
        returns (one contiguous int16 array per component). Returns the
        image's own info and the buffers written; re-probes and retries
        once if the geometry grew (``get_bufs`` is asked again, so a
        reallocated scratch is picked up)."""
        n = int(self.info.ncomp)
        out = _lib.VpfJpegInfo()
        for _ in range(2):
            bufs = get_bufs()
            ptrs = (_lib.i16p * n)(*(bufs[c].ctypes.data_as(_lib.i16p)
                                     for c in range(n)))
            caps = (C.c_uint32 * 4)(*(b.shape[0] for b in bufs[:n]),
                                    *([0] * (4 - n)))
            rc = self._lib.vpf_jpeg_parse(a.ctypes.data_as(_lib.u8p), a.size,
                                          C.byref(out), ptrs, caps)
            if rc == _lib.OK:
                break
            if rc == _lib.ERR_DECODE:  # the geometry grew: re-probe, retry
                self.probe(a)
                n = int(self.info.ncomp)
                continue
            raise JpegStreamError(_lib.last_error())
        else:
            raise RuntimeError(_lib.last_error())
        # _track_changes may reallocate self._bufs: return what was written
        self._track_changes(out, n)
        return out, bufs

    def _track_changes(self, out, n: int) -> None:
        """Adopt a structural or table change (byte compares: this runs
        once a frame)."""
        info = self.info
        structural = (
            (out.width, out.height, int(out.ncomp))
            != (info.width, info.height, int(info.ncomp))
            or bytes(out.hs)[:4 * n] != bytes(info.hs)[:4 * n]
            or bytes(out.vs)[:4 * n] != bytes(info.vs)[:4 * n])
        tables = any(bytes(out.qt[c]) != bytes(info.qt[c]) for c in range(n))
        if structural or tables:
            self._adopt(out)

    def decode_into(self, data, outs) -> _lib.VpfJpegInfo:
        """Entropy-decode one image straight into caller arrays (one
        contiguous ``[blocks, 64]`` int16 per component, enough capacity
        guaranteed by the caller) — the loaders' zero-copy path. Returns
        the image's info."""
        a = _as_u8(data)
        if self.info is None:
            self.probe(a)
        out, _ = self._parse_into(a, lambda: outs)
        return out

    def decode(self, data) -> tuple:
        """One image → per-component ``[blocks, 64]`` int16 (zigzag),
        fresh copies (the scratch is reused). Raises
        :class:`JpegStreamError` for streams the device path cannot take
        or corrupt ones."""
        a = _as_u8(data)
        if self.info is None:
            self.probe(a)
        out, bufs = self._parse_into(a, lambda: self._bufs)
        # slice to the geometry THIS image declared (a shrinking change
        # fits the old scratch)
        return tuple(bufs[c][: int(out.bh[c]) * int(out.bw[c])].copy()
                     for c in range(int(out.ncomp)))

    def decode_batch(self, packets: Sequence) -> tuple:
        """Packets → stacked ``[N, blocks, 64]`` batches. All must share
        one geometry and one table set (the device folds the tables into
        its bases): a change inside the batch raises."""
        frames = [self.decode(p) for p in packets]
        if self.quant_dirty:
            self.quant_dirty = False
            raise JpegStreamError(
                "quant tables changed mid-batch; decode frame-by-frame "
                "and rebuild the pipeline bases (set_quant_tables)")
        if len({tuple(c.shape for c in f) for f in frames}) != 1:
            raise JpegStreamError(
                "geometry changed mid-batch; split the batch at the change")
        return tuple(np.stack([f[c] for f in frames])
                     for c in range(len(frames[0])))


class JpegCoefEncoder:
    """Entropy-encode quantized DCT coefficients into baseline JFIF with
    the Annex K Huffman tables (``vpf_jpeg_encode``): the host half of
    the split encoder. :meth:`encode` returns a complete JPEG; concatenate
    them for raw MJPEG or hand them to :class:`MjpegWriter`'s muxer.
    One encoder per thread: its output buffer is reused per call."""

    def __init__(self, width: int, height: int, quality: int = 90,
                 subsampled=True, quant_tables=None,
                 restart_interval: int = 0):
        from ..ops.jpeg import _norm_sampling, encode_geometry, \
            std_quant_tables

        self._lib = _lib.load()
        sampling = _norm_sampling(subsampled)
        if sampling == "420" and (height % 2 or width % 2):
            raise ValueError("4:2:0 JPEG size must be even")
        if sampling == "422" and width % 2:
            raise ValueError("4:2:2 JPEG width must be even")
        if quant_tables is None:
            quant_tables = std_quant_tables(quality)
        ql, qc = (np.asarray(t, np.uint16).reshape(64) for t in quant_tables)
        if max(int(ql.max()), int(qc.max())) > 255:
            raise ValueError(
                "baseline JPEG quant tables are 8-bit (all values <= 255)")
        self.width, self.height = int(width), int(height)
        self.sampling = sampling
        self.subsampled = sampling == "420"  # legacy flag
        self.ncomp = 1 if sampling == "gray" else 3
        self.quant_tables = (ql, qc)
        self.restart_interval = int(restart_interval)
        self._params = _lib.VpfJpegEncParams(
            width=self.width, height=self.height, ncomp=self.ncomp,
            # native mode: 0 = 4:4:4, 1 = 4:2:0, 2 = 4:2:2
            subsampled={"444": 0, "420": 1, "422": 2, "gray": 0}[sampling],
            restart_interval=self.restart_interval)
        self._params.qt_luma[:] = [int(x) for x in ql]
        self._params.qt_chroma[:] = [int(x) for x in qc]
        (bhy, bwy), (bhc, bwc), _, _ = encode_geometry(self.height,
                                                       self.width, sampling)
        self._nblocks = (bhy * bwy,) if self.ncomp == 1 else (
            bhy * bwy, bhc * bwc, bhc * bwc)
        # worst case a block ≈ (27 + 63·26) bits, doubled for 0xFF
        # stuffing, plus the headers
        self._cap = sum(self._nblocks) * 420 + 8192
        self._out = np.empty(self._cap, np.uint8)

    def clone(self) -> "JpegCoefEncoder":
        """An encoder of the same configuration (one per thread)."""
        return JpegCoefEncoder(self.width, self.height,
                               subsampled=self.sampling,
                               quant_tables=self.quant_tables,
                               restart_interval=self.restart_interval)

    def encode(self, *coeffs) -> bytes:
        """One frame of ``[blocks, 64]`` int16 zigzag coefficients per
        component (1 for grayscale, 3 otherwise) → JPEG bytes."""
        if len(coeffs) != self.ncomp:
            raise ValueError(
                f"expected {self.ncomp} coefficient arrays, got {len(coeffs)}")
        comps = []
        for c, want in zip(coeffs, self._nblocks):
            a = _host_i16(c)
            if a.shape != (want, 64):
                raise ValueError(
                    f"coefficient shape {a.shape} != ({want}, 64)")
            comps.append(a)
        ptrs = (_lib.i16p * self.ncomp)(*(c.ctypes.data_as(_lib.i16p)
                                          for c in comps))
        size = C.c_size_t(0)
        rc = self._lib.vpf_jpeg_encode(C.byref(self._params), ptrs,
                                       self._out.ctypes.data_as(_lib.u8p),
                                       self._cap, C.byref(size))
        if rc != _lib.OK:
            raise RuntimeError(_lib.last_error())
        return bytes(self._out[: size.value])

    def encode_batch(self, *coeffs) -> list:
        """Stacked ``[N, blocks, 64]`` batches (host arrays or tensors on
        any device) → one JPEG a frame."""
        coeffs = tuple(_host_i16(c) for c in coeffs)
        return [self.encode(*(c[i] for c in coeffs))
                for i in range(coeffs[0].shape[0])]


class MjpegWriter:
    """Write an MJPEG stream through the split encoder: resize + CSC +
    fDCT + quant on the device (:class:`~..ops.jpeg.JpegDeviceEncoder`),
    then host entropy packing. ``container=None`` writes raw concatenated
    JPEGs (a stream libav demuxes, and :class:`MjpegReader` reads);
    a container name (``"avi"``…) muxes through
    :class:`~.muxer.StreamMuxer`, which needs the libav runtime.
    ``device``: CUDA by default, ``"cpu"`` for the CPU."""

    def __init__(self, url: str, width: int, height: int, quality: int = 90,
                 fps: float = 30.0, container: Optional[str] = None,
                 method: str = "lanczos", restart_interval: int = 0,
                 sampling="420", device=None):
        from ..ops.jpeg import JpegDeviceEncoder

        self.device = JpegDeviceEncoder(height, width, quality=quality,
                                        method=method, subsampled=sampling,
                                        device=device)
        self.coef = JpegCoefEncoder(width, height,
                                    quant_tables=self.device.quant_tables,
                                    subsampled=sampling,
                                    restart_interval=restart_interval)
        self._mux = None
        self._file = None
        if container is not None:
            from .muxer import StreamMuxer

            self._mux = StreamMuxer(url, CodecId.MJPEG, width, height,
                                    fps=fps, format=container)
        else:
            self._file = open(url, "wb")
        self.frames_written = 0

    def write_rgb(self, rgb) -> None:
        """(N, H, W, 3) u8 RGB batch of any size (resized on the device)."""
        self._emit(self.device.encode_rgb(rgb))

    def write_planes(self, *planes) -> None:
        """u8 plane batches at the target geometry: (y, u, v), or (y,)
        for a grayscale writer."""
        self._emit(self.device.encode_planes(*planes))

    def _emit(self, coeffs) -> None:
        for pkt in self.coef.encode_batch(*coeffs):
            if self._mux is not None:
                self._mux.write(pkt, pts=self.frames_written)
            else:
                self._file.write(pkt)
            self.frames_written += 1

    def close(self) -> None:
        if self._mux is not None:
            self._mux.close()
            self._mux = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _to_host_async(coeffs) -> tuple:
    """Device coefficient batches → ``(host tensors, landed)``: on CUDA
    one non-blocking copy each into pinned memory and the event that
    marks them landed; host data as it is, with None."""
    if not coeffs[0].is_cuda:
        return tuple(coeffs), None
    host = tuple(torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                 for c in coeffs)
    with torch.cuda.device(coeffs[0].device):
        for h, c in zip(host, coeffs):
            h.copy_(c, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record()
    return host, landed


class MjpegTranscoder:
    """MJPEG → MJPEG transcode with the whole pixel path on the device.

    Packets entropy-decode to coefficients on the host, one
    :class:`~..ops.jpeg.JpegDeviceTranscoder` call per batch runs dequant
    / IDCT → optional YUV resize → fDCT / requant, and the coefficients
    come back by a non-blocking copy and entropy-encode to JFIF. The host
    entropy-decodes batch *i+1* while the device transforms batch *i*.
    With ``workers > 1`` (default: one per core, at most 8) both host
    halves also fan out per frame across threads (every MJPEG packet is
    a standalone JPEG and the native calls drop the GIL); output order
    and bytes are the same on any worker count.

    ``sink``: an output path (raw concatenated JPEGs, or a container with
    ``container=``) or None to drop the packets; ``run(on_packet)``
    streams them elsewhere. Demuxing needs the libav runtime.
    """

    def __init__(self, source, sink: Optional[str] = None,
                 quality: int = 90,
                 out_size: Optional[tuple] = None,
                 container: Optional[str] = None, restart_interval: int = 0,
                 batch: int = 8, method: str = "lanczos",
                 compute: str = "auto", max_frames: int = 0,
                 workers: int = 0, device=None):
        from ..ops.jpeg import JpegDeviceTranscoder
        from .demuxer import FFmpegDemuxer

        self._mux = None
        self._file = None
        self._enc_ex = None  # the encode pool (workers > 1)
        self._enc_cache = None
        self.demuxer = FFmpegDemuxer(source)
        try:
            if self.demuxer.codec != CodecId.MJPEG:
                raise JpegStreamError(
                    f"stream codec is {self.demuxer.codec.name}, not MJPEG")
            self.coef = JpegCoefDecoder()
            self.batch = int(batch)
            self.max_frames = int(max_frames)
            self.workers = (int(workers) if workers > 0
                            else min(8, os.cpu_count() or 1))
            self._cfg = dict(quality=quality, out_size=out_size,
                             method=method, compute=compute,
                             restart_interval=restart_interval,
                             device=resolve_device(device))
            first = self.demuxer.demux()
            if first is None:
                raise JpegStreamError("empty MJPEG stream")
            self._pending = [first.packet.copy()]
            info = self.coef.probe(self._pending[0])
            self.device = JpegDeviceTranscoder(
                info, quality=quality, out_size=out_size, method=method,
                compute=compute, device=self._cfg["device"])
            self._new_sink_encoder()
            if sink is not None:
                if container is not None:
                    from .muxer import StreamMuxer

                    self._mux = StreamMuxer(
                        sink, CodecId.MJPEG, self.device.out_w,
                        self.device.out_h,
                        fps=self.demuxer.framerate or 30.0, format=container)
                else:
                    self._file = open(sink, "wb")
        except BaseException:
            self.close()
            raise

    def _new_sink_encoder(self) -> None:
        self.sink_coef = JpegCoefEncoder(
            self.device.out_w, self.device.out_h,
            subsampled=self.device.sampling,
            quant_tables=self.device.quant_tables,
            restart_interval=self._cfg["restart_interval"])

    def _packets(self) -> Iterator[np.ndarray]:
        n = 0
        while True:
            if self.max_frames and n >= self.max_frames:
                return
            if self._pending:
                pkt = self._pending.pop(0)
            else:
                r = self.demuxer.demux()
                if r is None:
                    return
                pkt = r.packet.copy()
            n += 1
            yield pkt

    def _frames(self):
        """``(frame_coeffs, snapshot)`` in stream order, entropy-decoded
        on ``workers`` threads (one decoder each) in a bounded window."""
        local = threading.local()

        def one(pkt):
            dec = getattr(local, "dec", None)
            if dec is None:
                dec = local.dec = JpegCoefDecoder()
            f = dec.decode(pkt)
            return f, _snapshot(dec.info)

        yield from _bounded_ordered_map(one, self._packets(), self.workers)

    def _coef_batches(self):
        """Stacked coefficient batches, split at a table or geometry
        change (as :class:`MjpegReader`)."""
        if self.workers <= 1:
            yield from self._coef_batches_serial()
            return
        pend: list = []
        key0 = None
        for f, snap in self._frames():
            key = (_geo_key(snap), tuple(snap.qt))
            if key0 is None:
                key0 = key
            elif key != key0:
                if pend:
                    yield self._stack(pend)
                    pend = []
                self._on_key_change(key0, key, snap)
                key0 = key
            pend.append(f)
            if len(pend) >= self.batch:
                yield self._stack(pend)
                pend = []
        if pend:
            yield self._stack(pend)

    def _on_key_change(self, key0, key, snap) -> None:
        """Rebuild for a mid-stream change (the caller has flushed the
        frames before it)."""
        from ..ops.jpeg import JpegDeviceTranscoder

        if key[0] != key0[0]:  # geometry: rebuild
            resizing = self._cfg["out_size"] is not None
            if not resizing and self._mux is not None:
                raise JpegStreamError(
                    "mid-stream geometry change with a container sink "
                    "needs a fixed out_size (the muxed stream has one "
                    "geometry)")
            self.device = JpegDeviceTranscoder(
                snap, quality=self._cfg["quality"],
                out_size=self._cfg["out_size"], method=self._cfg["method"],
                compute=self._cfg["compute"], device=self._cfg["device"])
            if not resizing:  # the output geometry follows the source
                self._new_sink_encoder()
        else:  # tables only: swap the inverse bases
            self.device.set_src_quant_tables(list(snap.qt))

    def _coef_batches_serial(self):
        """Serial batcher: a header peek a packet decides changes before
        the entropy decode writes straight into a coefficient ring. The
        device call has copied a batch out when it returns (a host copy
        on the CPU, a pinned staging copy on CUDA), so one ring serves."""
        dec = self.coef
        ring = None
        fill = 0
        key0 = None
        for pkt in self._packets():
            snap = _snapshot(dec.peek(pkt))
            key = (_geo_key(snap), tuple(snap.qt))
            if key0 is None:
                key0 = key
                ring = _coef_ring(snap, self.batch)
            elif key != key0:
                if fill:
                    yield tuple(c[:fill].numpy() for c in ring)
                    fill = 0
                if key[0] != key0[0]:
                    ring = _coef_ring(snap, self.batch)
                self._on_key_change(key0, key, snap)
                key0 = key
            dec.decode_into(pkt, [c[fill].numpy() for c in ring])
            fill += 1
            if fill >= self.batch:
                yield tuple(c.numpy() for c in ring)
                fill = 0
        if fill:
            yield tuple(c[:fill].numpy() for c in ring)

    @staticmethod
    def _stack(frames) -> tuple:
        return tuple(np.stack([f[c] for f in frames])
                     for c in range(len(frames[0])))

    def run(self, on_packet=None):
        """Pump the whole stream → :class:`~.transcode.TranscodeStats`.
        ``on_packet(jpeg_bytes, frame_index)`` receives every output
        image too."""
        from .transcode import TranscodeStats

        st = TranscodeStats()
        t0 = time.perf_counter()
        inflight = None  # (host coefficients, landed event, sink encoder)
        try:
            for coeffs in self._coef_batches():
                out = _to_host_async(self.device(*coeffs)) + (self.sink_coef,)
                if inflight is not None:
                    self._drain(inflight, st, on_packet)
                inflight = out  # the device works while we decode on
            if inflight is not None:
                self._drain(inflight, st, on_packet)
            st.wall_s = time.perf_counter() - t0
            return st
        finally:
            self.close()

    def _drain(self, inflight, st, on_packet) -> None:
        coeffs, landed, coder = inflight
        if landed is not None:
            landed.synchronize()
        coeffs = tuple(_host_i16(c) for c in coeffs)
        if self.workers <= 1:
            pkts = coder.encode_batch(*coeffs)
        else:
            # per-frame fan-out: each worker packs a stride of frames
            # with its own encoder; one pool for the whole run
            if self._enc_ex is None:
                self._enc_ex = ThreadPoolExecutor(max_workers=self.workers)
            n = coeffs[0].shape[0]
            w = min(self.workers, n)
            encs = self._enc_pool(coder, w)
            pkts: list = [None] * n

            def pack(widx):
                for i in range(widx, n, w):
                    pkts[i] = encs[widx].encode(*(c[i] for c in coeffs))

            list(self._enc_ex.map(pack, range(w)))
        for pkt in pkts:
            if self._mux is not None:
                self._mux.write(pkt, pts=st.frames)
            elif self._file is not None:
                self._file.write(pkt)
            if on_packet is not None:
                on_packet(pkt, st.frames)
            st.frames += 1
            st.out_bytes += len(pkt)

    def _enc_pool(self, coder: JpegCoefEncoder, w: int) -> list:
        """Per-worker clones of the sink encoder, cached until the sink
        encoder is rebuilt."""
        cache = self._enc_cache
        if cache is None or cache[0] is not coder or len(cache[1]) < w:
            cache = self._enc_cache = (
                coder, [coder] + [coder.clone() for _ in range(w - 1)])
        return cache[1]

    def close(self) -> None:
        if self._enc_ex is not None:
            self._enc_ex.shutdown(wait=True)
            self._enc_ex = None
        if self._mux is not None:
            self._mux.close()
            self._mux = None
        if self._file is not None:
            self._file.close()
            self._file = None
        dm = getattr(self, "demuxer", None)
        if dm is not None:
            dm.close()
            self.demuxer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MjpegReader:
    """Demux + decode an MJPEG stream through the split codec.

    ``source`` is anything :class:`~.demuxer.FFmpegDemuxer` accepts.
    Yields device batches from :class:`~..ops.jpeg.JpegDevicePipeline`:
    ``output='planes'`` for the u8 (y, u, v) planes, or a fused mode with
    the resize. Streams the device path cannot take raise
    :class:`JpegStreamError` at construction: read them with
    ``VideoReader(source)``. ``device``: CUDA by default, ``"cpu"`` for
    the CPU. Demuxing needs the libav runtime.
    """

    def __init__(self, source, out_size: Optional[tuple] = None,
                 output: str = "rgb_u8", method: str = "lanczos",
                 compute: str = "auto", batch: int = 8, device=None):
        from ..ops.jpeg import JpegDevicePipeline
        from .demuxer import FFmpegDemuxer

        self.demuxer = FFmpegDemuxer(source)
        if self.demuxer.codec != CodecId.MJPEG:
            raise JpegStreamError(
                f"stream codec is {self.demuxer.codec.name}, not MJPEG")
        self.coef = JpegCoefDecoder()
        self.batch = int(batch)
        first = self.demuxer.demux()
        if first is None:
            raise JpegStreamError("empty MJPEG stream")
        self._pending = [first.packet.copy()]
        info = self.coef.probe(self._pending[0])
        self._out_size = out_size  # None: follow the source geometry
        self.pipeline = JpegDevicePipeline(info, out_size=out_size,
                                           output=output, method=method,
                                           compute=compute, device=device)
        self.device = self.pipeline.device
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.width = self.pipeline.width
        self.height = self.pipeline.height

    def _packets(self) -> Iterator[np.ndarray]:
        while self._pending:
            yield self._pending.pop(0)
        while True:
            r = self.demuxer.demux()
            if r is None:
                return
            yield r.packet.copy()

    def batches(self):
        """Yield device batches of up to ``batch`` frames (a ragged tail).

        A table change swaps the pipeline's bases; a geometry change
        splits the batch there and rebuilds the pipeline. A header peek a
        packet decides changes before the entropy decode writes straight
        into one of two pinned coefficient rings; each batch goes to the
        device by one copy a component on a side stream, and a ring is
        written again only after its copy's CUDA event."""
        pin = self.device.type == "cuda"
        rings = None
        ring_i = fill = 0
        key0 = None
        uploaded = [None, None]  # each ring's copy event

        def dispatch(n):
            host = [c[:n] for c in rings[ring_i]]
            staged, uploaded[ring_i] = upload(host, self.device,
                                              self._copy_stream)
            return self.pipeline(*staged)

        for pkt in self._packets():
            snap = _snapshot(self.coef.peek(pkt))
            key = (_geo_key(snap), tuple(snap.qt))
            if key0 is None:
                key0 = key
                rings = [_coef_ring(snap, self.batch, pin) for _ in range(2)]
            elif key != key0:
                if fill:
                    yield dispatch(fill)
                    ring_i ^= 1
                    fill = 0
                if key[0] != key0[0]:  # geometry: new rings, new pipeline
                    rings = [_coef_ring(snap, self.batch, pin)
                             for _ in range(2)]
                    uploaded = [None, None]
                    p = self.pipeline
                    self.pipeline = p.__class__(
                        snap, out_size=self._out_size, output=p.output,
                        method=p.method, compute=p.compute, device=p.device)
                    self.width = self.pipeline.width
                    self.height = self.pipeline.height
                else:  # tables only: swap the bases
                    self.pipeline.set_quant_tables(snap)
                key0 = key
            if fill == 0 and uploaded[ring_i] is not None:
                uploaded[ring_i].synchronize()
                uploaded[ring_i] = None
            ring = rings[ring_i]
            self.coef.decode_into(pkt, [c[fill].numpy() for c in ring])
            self.coef.quant_dirty = False  # handled through the peek's key
            fill += 1
            if fill >= self.batch:
                yield dispatch(fill)
                ring_i ^= 1
                fill = 0
        if fill:
            yield dispatch(fill)

    def frames(self):
        """Per-frame iterator over :meth:`batches`."""
        for out in self.batches():
            if isinstance(out, tuple):  # planes
                for i in range(out[0].shape[0]):
                    yield tuple(p[i] for p in out)
            else:
                yield from out
