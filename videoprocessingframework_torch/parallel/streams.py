"""Multi-stream decode → batch → device pipeline (the counterpart of the
JAX package's ``parallel/streams.py``).

The reference's stream-per-thread model (samples/SampleDecodeMultiThread.py:
N threads, a CUDA stream and an NPP chain each) becomes: N decode threads
(GIL-free native calls) decode **straight into slots of packed batch
buffers** → each full batch is ONE non-blocking host→device copy on a side
stream → ONE batched post-processing call for all streams → results in
flight against the next upload.

On CUDA the batch buffers are pinned, so the copy reads them directly. A
buffer goes back to the decode threads only after its copy's CUDA event
has completed; a decode thread writing into a buffer whose copy has not
landed would corrupt a batch silently. The post-processing's own event
marks a batch as ready before it is yielded.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core import geometry
from ..core.enums import PixelFormat
from ..io.decoder import VideoReader
from ..utils.device import resolve_device, upload_ordered
from ..utils.tracing import StageTimer


@dataclass
class StreamStats:
    frames_decoded: int = 0
    batches: int = 0
    wall_s: float = 0.0

    @property
    def fps(self) -> float:
        return self.frames_decoded / self.wall_s if self.wall_s else 0.0


def _host_batch(batch: int, rows: int, width: int, pinned: bool):
    """A (batch, rows, width) uint8 host buffer: a pinned tensor and its
    numpy view (shared memory), or a plain numpy array."""
    if not pinned:
        return None, np.empty((batch, rows, width), np.uint8)
    t = torch.empty((batch, rows, width), dtype=torch.uint8, pin_memory=True)
    return t, t.numpy()


class _BatchRing:
    """Ring of packed host batch buffers with per-slot tickets.

    Buffer layout: (batch, rows, width) uint8, rows = the packed frame's
    rows for the format (NV12: H + H/2). Workers claim (buffer, slot)
    tickets in FIFO order, decode a frame into the slot and mark it done;
    the consumer takes buffers in issue order and recycles each once the
    device no longer reads it.
    """

    def __init__(self, n_buffers: int, batch: int, rows: int, width: int,
                 pinned: bool = False):
        self.batch = batch
        pairs = [_host_batch(batch, rows, width, pinned)
                 for _ in range(n_buffers)]
        self.tensors = [t for t, _ in pairs]  # the pinned tensors, or None
        self.buffers = [a for _, a in pairs]
        self.done: List[set] = [set() for _ in range(n_buffers)]
        self.cond = threading.Condition()
        self.tickets: queue.Queue = queue.Queue()
        self.order: List[int] = []
        for b in range(n_buffers):
            self._issue(b)

    def _issue(self, b: int) -> None:
        with self.cond:
            self.order.append(b)
        for s in range(self.batch):
            self.tickets.put((b, s))

    def claim(self, timeout: float = 0.05):
        try:
            return self.tickets.get(timeout=timeout)
        except queue.Empty:
            return None

    def unclaim(self, ticket) -> None:
        self.tickets.put(ticket)

    def complete(self, b: int, s: int) -> None:
        with self.cond:
            self.done[b].add(s)
            self.cond.notify_all()

    def take(self, allow_partial: Callable[[], bool]):
        """The oldest buffer once it is full, or, when ``allow_partial()``
        turns True, with however many slots are done: (index, sorted slot
        list)."""
        with self.cond:
            while True:
                if self.order:
                    b = self.order[0]
                    if len(self.done[b]) == self.batch or allow_partial():
                        self.order.pop(0)
                        return b, sorted(self.done[b])
                self.cond.wait(timeout=0.05)

    def recycle(self, b: int) -> None:
        with self.cond:
            self.done[b].clear()
        self._issue(b)


class _DecodeWorker(threading.Thread):
    """One stream: decodes frames straight into claimed batch slots."""

    def __init__(self, sid, source, ring, stop_evt, max_frames, loop,
                 threads, out_format, gate=None):
        super().__init__(daemon=True, name=f"vpf-decode-{sid}")
        self.sid = sid
        self.gate = gate
        self.source = source
        self.ring = ring
        self.stop_evt = stop_evt
        self.max_frames = max_frames
        self.loop = loop
        self.decode_threads = threads
        self.out_format = out_format
        self.frames = 0
        self.error: Optional[BaseException] = None

    def _emit(self, reader) -> bool:
        """Decode one frame into a claimed slot; False at stream end."""
        while True:
            ticket = self.ring.claim()
            if ticket is not None:
                break
            if self.stop_evt.is_set():
                return False
        b, s = ticket
        if self.gate is not None:
            self.gate.wait()
        try:
            frame = reader.decode(out=self.ring.buffers[b][s])
        except BaseException:
            self.ring.unclaim(ticket)
            raise
        if frame is None:
            self.ring.unclaim(ticket)
            return False
        self.ring.complete(b, s)
        self.frames += 1
        return True

    def run(self):
        try:
            while not self.stop_evt.is_set():
                reader = _reader(self.source, self.decode_threads,
                                 self.out_format)
                while not self.stop_evt.is_set():
                    if not self._emit(reader):
                        break
                    if self.max_frames and self.frames >= self.max_frames:
                        return
                if not self.loop or self.stop_evt.is_set():
                    return
        except BaseException as e:
            self.error = e


def _reader(source, threads, out_format) -> VideoReader:
    r = VideoReader(source, threads=threads)
    if out_format is not None:
        r.decoder.output_format = out_format
    return r


class MultiStreamPipeline:
    """Decode N streams in parallel and yield batched device results.

    ``postproc`` is a callable over ONE packed batch tensor on ``device``
    (e.g. a :class:`~..ops.fused.FusedPipeline` bound to packed NV12);
    None yields the uploaded packed batches. ``device`` is CUDA by
    default; pass ``"cpu"`` to run on the CPU.

    Threading policy by host size (measured on 1-core hosts, where decode
    threads starve the transfer path 5-10×):

    * ``serial``: one core, no worker threads at all;
    * ``gate_decode``: few cores, threads that alternate decode and
      upload;
    * overlapped: enough cores, full overlap (the default design).
    """

    def __init__(
        self,
        sources: Sequence[str],
        batch_size: int = 8,
        postproc: Optional[Callable] = None,
        device=None,
        max_frames_per_stream: Optional[int] = None,
        loop_streams: bool = False,
        decode_threads: int = 0,  # 0 = libav's own thread count
        inflight: int = 3,
        out_format: PixelFormat = PixelFormat.NV12,
        gate_decode: Optional[bool] = None,
        serial: Optional[bool] = None,
    ):
        self.sources = list(sources)
        self.batch_size = batch_size
        self.postproc = postproc
        self.device = resolve_device(device)
        self.max_frames = max_frames_per_stream
        self.loop_streams = loop_streams
        self.decode_threads = decode_threads
        self.inflight = max(1, inflight)
        self.out_format = out_format
        ncpu = os.cpu_count() or 1
        if serial is None:
            serial = ncpu == 1
        self.serial = serial
        if gate_decode is None:
            gate_decode = not serial and ncpu <= len(sources) + 1
        self.gate_decode = gate_decode
        if gate_decode:
            self.inflight = 1
        self.stats = StreamStats()
        self.timer = StageTimer("streams")

        probe = VideoReader(self.sources[0])
        self.width = probe.width()
        self.height = probe.height()
        self._rows = (geometry.host_frame_size(out_format, self.width,
                                               self.height) // self.width)
        self._on_gpu = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._on_gpu
                             else None)

    def _dispatch(self, host: np.ndarray, pinned: Optional[torch.Tensor]):
        """Upload one host batch and enqueue the post-processing. Returns
        (out, uploaded event, done event); the events are None on the CPU,
        where the batch is copied out of the ring buffer first."""
        with self.timer.measure("dispatch"):
            src = pinned
            if src is None:
                src = torch.from_numpy(host)
                if self._on_gpu:
                    src = src.pin_memory()
            (dev,), uploaded = upload_ordered([src], self.device,
                                              self._copy_stream)
            out = self.postproc(dev) if self.postproc else dev
            done = None
            if self._on_gpu:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        return out, uploaded, done

    def _serial_batches(self) -> Iterator:
        """Single-threaded round-robin over all sources: the fastest path
        on one-core hosts, where threads only add scheduler thrash."""
        t0 = time.perf_counter()
        pinned, buf = _host_batch(self.batch_size, self._rows, self.width,
                                  self._on_gpu)
        readers = [_reader(s, self.decode_threads, self.out_format)
                   for s in self.sources]
        frames = [0] * len(readers)
        live = [True] * len(readers)
        slot = 0

        def dispatch(count):
            # wait for the batch at once: the buffer is decoded into again
            # right after (keeping a batch in flight here measured 3.5×
            # slower on small hosts in the JAX package)
            out, _, done = self._dispatch(
                buf[:count], None if pinned is None else pinned[:count])
            if done is not None:
                done.synchronize()
            self.stats.batches += 1
            self.stats.frames_decoded += count
            return out

        while any(live):
            for i, r in enumerate(readers):
                if not live[i]:
                    continue
                if self.max_frames and frames[i] >= self.max_frames:
                    live[i] = False
                    continue
                if r.decode(out=buf[slot]) is None:
                    if self.loop_streams:
                        readers[i] = _reader(self.sources[i],
                                             self.decode_threads,
                                             self.out_format)
                    else:
                        live[i] = False
                    continue
                frames[i] += 1
                slot += 1
                if slot == self.batch_size:
                    yield dispatch(slot)
                    slot = 0
        if slot:
            yield dispatch(slot)
        self.stats.wall_s = time.perf_counter() - t0

    def batches(self) -> Iterator:
        if self.serial:
            yield from self._serial_batches()
            return
        t0 = time.perf_counter()
        ring = _BatchRing(self.inflight + 2, self.batch_size, self._rows,
                          self.width, pinned=self._on_gpu)
        stop = threading.Event()
        gate = None
        if self.gate_decode:
            gate = threading.Event()
            gate.set()
        workers = [
            _DecodeWorker(i, src, ring, stop, self.max_frames,
                          self.loop_streams, self.decode_threads,
                          self.out_format, gate)
            for i, src in enumerate(self.sources)
        ]
        for w in workers:
            w.start()

        def workers_done() -> bool:
            return all(not w.is_alive() for w in workers)

        inflight: List = []  # (buffer index, out, uploaded, done, count)

        def flush_one():
            b, out, uploaded, done, count = inflight.pop(0)
            if uploaded is not None:
                uploaded.synchronize()  # the copy has read the buffer
            ring.recycle(b)
            if done is not None:
                done.synchronize()
            self.stats.batches += 1
            self.stats.frames_decoded += count
            return out

        try:
            while True:
                for w in workers:
                    if w.error:
                        raise w.error
                b, slots = ring.take(allow_partial=workers_done)
                if not slots:
                    ring.recycle(b)
                    if workers_done():
                        break
                    continue
                host, pinned = ring.buffers[b], ring.tensors[b]
                if len(slots) < self.batch_size:  # a partial last batch
                    host, pinned = host[np.asarray(slots)], None
                if gate is not None:
                    gate.clear()
                try:
                    out, uploaded, done = self._dispatch(host, pinned)
                    if done is not None and gate is not None:
                        done.synchronize()
                finally:
                    if gate is not None:
                        gate.set()
                inflight.append((b, out, uploaded, done, len(slots)))
                if len(inflight) >= self.inflight:
                    yield flush_one()
        finally:
            stop.set()
            # leaving early: no copy may still read a buffer the decode
            # threads could write
            for _, _, uploaded, _, _ in inflight:
                if uploaded is not None:
                    uploaded.synchronize()
        while inflight:
            yield flush_one()
        self.stats.wall_s = time.perf_counter() - t0

    def run(self) -> StreamStats:
        for _ in self.batches():
            pass
        return self.stats
