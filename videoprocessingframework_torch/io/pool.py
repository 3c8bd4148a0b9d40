"""NativeDecodePool — the all-native multi-stream decode scheduler, fed
to a CUDA device.

N worker threads live entirely in C++ (io/native/pool.cpp): demux, decode
and frame packing never touch the interpreter. Python acquires whole
batches (zero-copy views into the pool's ring), uploads each batch with
ONE host→device copy, runs the post-processing on the device and releases
the ring slot once the device is done with it.

Upload path (:meth:`_RingFeed.batches`): the first time a generator
sees a ring slot it page-locks the slot's memory in place
(``cudaHostRegister``), and each batch is then one non-blocking copy
straight from its slot on a side stream, which does not wait for the
device's earlier work, so it runs under the previous batch's model. The
consumer stream waits on the copy's event before the post-processing,
and a second event after the post-processing is the barrier before the
slot is released to the decode workers. A slot that cannot be
page-locked goes through a pinned staging buffer instead, copied in by
the host and uploaded behind the consumer stream's earlier work. On the
CPU the batch is copied out of the ring before anything else, since
``torch.from_numpy`` aliases the slot.
"""

from __future__ import annotations

import ctypes as C
import os
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..core import geometry
from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..utils.device import (
    Staging,
    page_lock,
    page_unlock,
    resolve_device,
    upload,
    upload_ordered,
)
from ..utils.tracing import StageTimer


class _SlotLocks:
    """The ring slots one :meth:`_RingFeed.batches` generator has seen,
    keyed by address and size: whether each is copied to the device
    straight from its own page-locked memory, the addresses this
    generator locked (:meth:`unlock` unlocks them), and its
    ``upload_stats``."""

    def __init__(self, timer: StageTimer):
        self.timer = timer
        self.direct: dict = {}
        self.owned: list = []
        self.stats = {"direct": 0, "staged": 0, "registered": 0,
                      "register_s": 0.0}

    def direct_from(self, slot: np.ndarray) -> bool:
        """Whether ``slot`` is copied straight from its memory: locked the
        first time it is seen (the ``register`` stage), or locked already
        by another owner; False where the runtime refused."""
        key = (slot.ctypes.data, slot.nbytes)
        if key not in self.direct:
            t0 = time.perf_counter()
            with self.timer.measure("register"):
                got = page_lock(torch.from_numpy(slot))
            self.stats["register_s"] += time.perf_counter() - t0
            if got:
                self.owned.append(key[0])
                self.stats["registered"] += 1
            self.direct[key] = got is not None
        return self.direct[key]

    def unlock(self) -> None:
        """Unlock the slots this generator locked; call it once no copy
        from them is in flight."""
        for ptr in self.owned:
            page_unlock(ptr)
        self.owned.clear()


class _RingFeed:
    """``batches()`` over a ring of host batches: one upload, one
    post-processing call and one deferred slot release per batch.

    Subclasses provide ``width``, ``height``, ``batch_size``,
    ``plane_major``, ``frame_bytes``, ``device``, ``timer``,
    ``_n_buffers``, ``_acquire_raw() -> (numpy uint8 view of the whole
    slot, frame count) | (None, 0)``, ``release()`` and ``pause()``.

    :attr:`upload_stats` counts the running (or last) generator's
    uploads: ``direct`` batches copied from their page-locked slot,
    ``staged`` batches through a pinned staging buffer (every batch on
    the CPU), ``registered`` slots it page-locked and ``register_s`` the
    seconds that took.
    """

    def _split(self, flat: torch.Tensor, n: int, cap: int):
        """(y, u, v) or the packed (n, rows, W) batch from a flat buffer
        laid out like a ring slot of capacity ``cap``."""
        h, w = self.height, self.width
        if not self.plane_major:
            return (flat[: n * self.frame_bytes].view(n, -1, w),)
        ysz, csz = h * w, (h // 2) * (w // 2)
        y = flat[: n * ysz].view(n, h, w)
        u = flat[cap * ysz: cap * ysz + n * csz].view(n, h // 2, w // 2)
        v = flat[cap * (ysz + csz): cap * (ysz + csz) + n * csz]
        return y, u, v.view(n, h // 2, w // 2)

    def _upload(self, slot: np.ndarray, n: int, staging: Staging,
                direct: bool):
        """One batch onto the device as plane tensors. ``direct`` (a
        page-locked slot): one non-blocking H2D copy from the slot on the
        stage's side stream, in :func:`upload`'s discipline, timed as the
        ``upload`` stage. Otherwise through the stage's :class:`Staging`:
        the slot → its pinned buffer → one H2D copy behind the current
        stream's work, which then waits for it; the stage's ``done``
        event (the barrier, set by :meth:`batches` after the
        post-processing) guards the pinned buffer's reuse. Timed as the
        ``wait``, ``stage`` and ``upload`` stages; on the CPU the one
        clone is the ``stage``."""
        cap = self.batch_size
        timer = self.timer
        src = torch.from_numpy(slot)
        if direct:
            with timer.measure("upload"):
                (dev,), _ = upload([src], self.device, staging.stream)
            return self._split(dev, n, cap)
        if staging.stream is None:
            # from_numpy aliases the ring slot: copy before it is released
            with timer.measure("stage"):
                return self._split(staging.upload([src])[0], n, cap)
        if staging.barrier is not None:
            with timer.measure("wait"):
                staging.wait()  # the last H2D from this buffer is over
        with timer.measure("stage"):
            pinned = staging.stage([src])
        with timer.measure("upload"):
            (dev,), _ = upload_ordered(pinned, self.device, staging.stream)
        return self._split(dev, n, cap)

    def batches(self, postproc: Optional[Callable] = None,
                depth: int = 2) -> Iterator:
        """Yield post-processed device batches (or the device planes when
        ``postproc`` is None): ``postproc(y, u, v)`` for plane-major
        rings, ``postproc(packed)`` otherwise.

        ``depth`` batches are kept in flight: batch *i* is uploaded and
        dispatched before batch *i-depth+1* is waited on and its slot
        released. ``depth`` is capped below ``n_buffers`` so the decode
        workers keep free slots.

        Stages of ``self.timer`` (each also the span ``feed.<stage>``):
        ``acquire`` = waiting on the decode workers; ``dispatch`` = the
        batch's whole enqueue, made of ``register`` (page-locking a slot
        seen for the first time; CUDA only), ``upload`` (the H2D enqueue
        on the side stream and its events; CUDA only) and ``postproc``
        (the post-processing call and the event after it), and, for a
        slot that could not be page-locked, ``wait`` (blocked on the
        device until the staging buffer is free) and ``stage`` (the
        slot's copy into the pinned buffer); on the CPU ``stage`` is the
        clone; ``drain`` = blocked on the device until the oldest batch
        in flight is done.

        The slots this generator page-locked are unlocked when it ends
        or is closed, once the device has finished with them. A slot is
        released only after its batch's ``done`` event, which follows the
        H2D copy, so no copy reads a slot the decode workers refill.

        On a 1-core host each dispatch+drain window is bracketed with
        :meth:`pause`, so the decode workers sleep while a transfer is in
        flight.
        """
        depth = max(1, min(depth, self._n_buffers - 1))
        transfer_priority = (os.cpu_count() or 1) == 1
        self._set_worker_priority(transfer_priority)
        on_gpu = self.device.type == "cuda"
        stages = [Staging(self.device) for _ in range(depth)]
        pending: list = []  # (out, done event | None) in dispatch order
        locks = _SlotLocks(self.timer)
        self.upload_stats = stats = locks.stats

        def drain_one():
            out, done = pending[0]
            with self.timer.measure("drain"):
                if done is not None:
                    done.synchronize()
            pending.pop(0)
            self.release()
            return out

        k = 0
        try:
            while True:
                with self.timer.measure("acquire"):
                    slot, n = self._acquire_raw()
                if slot is None:
                    break
                if transfer_priority:
                    self.pause(True)
                try:
                    with self.timer.measure("dispatch"):
                        staging = stages[k % depth]
                        k += 1
                        direct = on_gpu and locks.direct_from(slot)
                        stats["direct" if direct else "staged"] += 1
                        planes = self._upload(slot, n, staging, direct)
                        with self.timer.measure("postproc"):
                            out = (planes if postproc is None
                                   else postproc(*planes))
                            done = None
                            if on_gpu:
                                done = torch.cuda.Event()
                                done.record(
                                    torch.cuda.current_stream(self.device))
                                staging.barrier = done
                    pending.append((out, done))
                    drained = drain_one() if len(pending) >= depth else None
                finally:
                    if transfer_priority:
                        self.pause(False)
                if drained is not None:
                    yield drained
            while pending:
                yield drain_one()
        finally:
            # early close / failure: wait for the device, then free the
            # held slots so no in-flight copy reads a recycled slot
            for _, done in pending:
                if done is not None:
                    done.synchronize()
                self.release()
            pending.clear()
            if locks.owned:
                for st in stages:
                    st.stream.synchronize()  # no copy still reads a slot
                locks.unlock()

    def acquire_planes(self):
        """Next batch of a plane-major ring as zero-copy contiguous
        (y, u, v) views, or None when drained. Call :meth:`release`."""
        if not self.plane_major:
            raise RuntimeError("acquire_planes() needs plane_major=True")
        slot, n = self._acquire_raw()
        if slot is None:
            return None
        return tuple(
            p.numpy() for p in self._split(torch.from_numpy(slot), n,
                                           self.batch_size)
        )

    # hooks with no native counterpart by default
    def pause(self, paused: bool = True) -> None:
        pass

    def _set_worker_priority(self, idle: bool) -> None:
        pass


class NativeDecodePool(_RingFeed):
    def __init__(
        self,
        sources: Sequence[str],
        batch_size: int = 8,
        out_format: PixelFormat = PixelFormat.NV12,
        loop: bool = False,
        max_frames_per_stream: int = 0,
        n_buffers: int = 4,
        plane_major: bool = False,
        device=None,
    ):
        """``plane_major`` (YUV420 only) lays each ring buffer out as
        [Y×batch | U×batch | V×batch], so each plane of a batch is one
        contiguous block and a batch splits on the device for free.
        ``device`` is where :meth:`batches` puts the batches (default
        CUDA; pass ``"cpu"`` to run on the CPU)."""
        from . import _lib
        from .demuxer import FFmpegDemuxer

        self.device = resolve_device(device)
        self._h = None
        self._lib = _lib.load()
        self._err = _lib.last_error
        probe = FFmpegDemuxer(sources[0])
        try:
            self.width, self.height = probe.width, probe.height
            self.color_space: ColorSpace = probe.color_space
            self.color_range: ColorRange = probe.color_range
        finally:
            probe.close()
        self.batch_size = batch_size
        self.out_format = PixelFormat(out_format)
        self.frame_bytes = geometry.host_frame_size(
            self.out_format, self.width, self.height
        )
        self._rows = self.frame_bytes // self.width
        if plane_major and self.out_format != PixelFormat.YUV420:
            raise ValueError("plane_major pools require YUV420 output")
        self.plane_major = bool(plane_major)
        urls = (C.c_char_p * len(sources))(
            *[str(s).encode() for s in sources]
        )
        self._n_buffers = n_buffers
        self._h = self._lib.vpf_pool_create(
            urls, len(sources), batch_size, self.frame_bytes,
            int(self.out_format), 1 if loop else 0, max_frames_per_stream,
            n_buffers, 1 if plane_major else 0,
        )
        if not self._h:
            raise RuntimeError(f"pool create failed: {self._err()}")
        self.timer = StageTimer("feed")

    def pause(self, paused: bool = True) -> None:
        """Transfer-priority handshake: ``pause(True)`` puts the decode
        workers to sleep after their in-flight frame; ``pause(False)``
        wakes them (:meth:`batches` brackets its transfers with it on a
        1-core host)."""
        self._lib.vpf_pool_pause(self._h, 1 if paused else 0)

    def _set_worker_priority(self, idle: bool) -> None:
        # SCHED_IDLE workers suit the serialized bracket; the overlapped
        # mode needs fair scheduling or decode starves
        self._lib.vpf_pool_worker_priority(self._h, 1 if idle else 0)

    def _acquire_raw(self):
        """The whole next ring slot as a uint8 view and its frame count,
        or (None, 0) when every stream is drained."""
        data = C.POINTER(C.c_uint8)()
        count = C.c_int()
        r = self._lib.vpf_pool_acquire_batch(
            self._h, C.byref(data), C.byref(count)
        )
        if r == 0:  # NEED_MORE: drained
            return None, 0
        if r != 1:
            raise RuntimeError(self._err())
        slot = np.ctypeslib.as_array(
            data, shape=(self.batch_size * self.frame_bytes,)
        )
        return slot, count.value

    def acquire(self) -> Optional[np.ndarray]:
        """Next packed batch as a zero-copy (count, rows, W) view, or None
        when drained. Call :meth:`release` when done."""
        if self.plane_major:
            raise RuntimeError(
                "plane-major pools have no packed per-frame layout; use "
                "acquire_planes() / batches()"
            )
        slot, n = self._acquire_raw()
        if slot is None:
            return None
        return slot[: n * self.frame_bytes].reshape(n, self._rows, self.width)

    def acquire_flat(self):
        """Next FULL plane-major batch as ONE zero-copy 1-D view of the
        slot ([Y×cap | U×cap | V×cap]), the (y, u, v) views for a ragged
        tail, or None when drained. Call :meth:`release`."""
        if not self.plane_major:
            raise RuntimeError("acquire_flat() needs plane_major=True")
        slot, n = self._acquire_raw()
        if slot is None:
            return None
        if n == self.batch_size:
            return slot
        return tuple(
            p.numpy() for p in self._split(torch.from_numpy(slot), n,
                                           self.batch_size)
        )

    def flat_postproc_fn(self, postproc: Callable) -> Callable:
        """``fn(flat)``: ``postproc(y, u, v)`` on ONE flat plane-major
        batch (the :meth:`acquire_flat` layout) already on the device —
        the single-transfer feed of MultiDeviceStreamPipeline. The planes
        are views of ``flat``; nothing is copied."""
        if not self.plane_major:
            raise RuntimeError("flat_postproc_fn() needs plane_major=True")
        cap = self.batch_size

        def fn(flat: torch.Tensor):
            return postproc(*self._split(flat, cap, cap))

        return fn

    def release(self) -> None:
        self._lib.vpf_pool_release_batch(self._h)

    @property
    def frames_decoded(self) -> int:
        return self._lib.vpf_pool_frames_decoded(self._h)

    @property
    def frames_dropped(self) -> int:
        """Frames zero-filled because frame packing failed."""
        return self._lib.vpf_pool_frames_dropped(self._h)

    @property
    def drop_reason(self) -> str:
        return self._lib.vpf_pool_drop_reason(self._h).decode(
            "utf-8", "replace"
        )

    def close(self) -> None:
        if self._h:
            self._lib.vpf_pool_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class HostBatchRing(_RingFeed):
    """A ring of seeded plane-major YUV420 batches in host memory, served
    through the same upload, event and depth loop as the decode pool.

    It stands in for the decode stage where the libav runtime cannot be
    built, so the device path still runs at the real batch and frame
    size; it decodes nothing.
    """

    def __init__(self, width: int, height: int, batch_size: int,
                 n_batches: int, n_buffers: int = 4, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.width, self.height = width, height
        self.batch_size = batch_size
        self.plane_major = True
        self.frame_bytes = geometry.host_frame_size(
            PixelFormat.YUV420, width, height
        )
        self._n_buffers = n_buffers
        rng = np.random.default_rng(seed)
        self._ring = [
            rng.integers(0, 256, batch_size * self.frame_bytes, np.uint8)
            for _ in range(n_buffers)
        ]
        self.held = 0  # slots acquired and not yet released
        self.rewind(n_batches)

    def rewind(self, n_batches: int) -> "HostBatchRing":
        """Serve ``n_batches`` more batches from the same ring contents."""
        if self.held:
            raise RuntimeError("rewind with slots still held")
        self._left = n_batches
        self._next = 0
        self.timer = StageTimer("feed")
        return self

    def _acquire_raw(self):
        if self._left == 0:
            return None, 0
        if self.held >= self._n_buffers:
            raise RuntimeError("every ring slot is held")
        self._left -= 1
        self.held += 1
        slot = self._ring[self._next]
        self._next = (self._next + 1) % self._n_buffers
        return slot, self.batch_size

    def release(self) -> None:
        self.held -= 1
