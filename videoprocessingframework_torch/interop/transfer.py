"""Host↔device transfer helpers: uploaders and downloaders with pinned
staging and double buffering.

The analog of the reference's transfer task family (CudaUploadFrame /
UploadBuffer / CudaDownloadSurface / DownloadCudaBuffer,
src/TC/src/Tasks.cpp:584-898) and its pinned-memory staging. Uploads go
through ``utils/device.py``'s :class:`~..utils.device.Staging`: on CUDA
a host frame is copied into a pinned staging buffer, then to the device
with one non-blocking copy on a side stream; the current stream waits on
an event recorded after that copy. Before a staging buffer is written
again, the host waits on the event of the copy that last read it, so a
transfer still in flight is never overwritten. On the CPU the data is
copied once, with no staging.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import geometry
from ..core.enums import PixelFormat
from ..core.surface import Surface, packed_bytes, split_frame
from ..utils.device import Staging, resolve_device
from ..utils.tracing import trace_range


def _flat_u8(frame) -> np.ndarray:
    return np.ascontiguousarray(frame).reshape(-1).view(np.uint8)


class FrameUploader:
    """Packed host frames → device Surfaces for a fixed geometry.

    ``device`` is CUDA by default; pass ``"cpu"`` to run on the CPU. The
    returned Surface's planes are views of one device tensor per frame."""

    def __init__(self, width: int, height: int, fmt: PixelFormat,
                 device=None):
        self.width = width
        self.height = height
        self.format = PixelFormat(fmt)
        self.device = resolve_device(device)
        self._staging = Staging(self.device)

    def upload(self, frame: np.ndarray) -> Surface:
        flat = torch.from_numpy(_flat_u8(frame))
        with trace_range("CudaUploadFrame"):
            (dev,) = self._staging.upload([flat])  # the caller keeps frame
            planes = split_frame(dev, self.format, self.width, self.height)
        return Surface(self.format, self.width, self.height, planes)

    __call__ = upload


class SurfaceDownloader:
    """Device Surfaces → packed host frames.

    On CUDA the frame is copied device→host into one pinned staging
    buffer, which :meth:`download` returns (as the JAX package returns its
    reused staging array) unless ``out`` is given. The host waits for that
    copy before returning, so the next download may reuse the buffer."""

    def __init__(self, width: int, height: int, fmt: PixelFormat):
        self.width = width
        self.height = height
        self.format = PixelFormat(fmt)
        self._nbytes = geometry.host_frame_size(fmt, width, height)
        self._staging = np.empty(self._nbytes, np.uint8)
        self._pinned: Optional[torch.Tensor] = None

    def _to_staging(self, surface: Surface) -> np.ndarray:
        if not surface.is_on_device:
            np.copyto(self._staging, surface.download())
            return self._staging
        data = packed_bytes(surface.planes)
        if data.numel() != self._nbytes:
            raise ValueError(
                f"surface holds {data.numel()} bytes, downloader expects "
                f"{self._nbytes}"
            )
        if not data.is_cuda:
            np.copyto(self._staging, data.numpy())
            return self._staging
        if self._pinned is None:
            self._pinned = torch.empty(self._nbytes, dtype=torch.uint8,
                                       pin_memory=True)
            self._staging = self._pinned.numpy()  # shares the pinned memory
        self._pinned.copy_(data, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(data.device))
        done.synchronize()
        return self._staging

    def download(self, surface: Surface, out: Optional[np.ndarray] = None):
        with trace_range("CudaDownloadSurface"):
            data = self._to_staging(surface)
        if out is not None:
            np.copyto(out.reshape(-1).view(np.uint8), data)
            return out
        return data

    __call__ = download


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


class DoubleBufferedUploader:
    """Streamed batch uploads with ``depth`` transfers in flight.

    Feed host batches (numpy arrays, or tuples / lists / dicts of them)
    with :meth:`put`; it returns the device tensors of the batch put
    ``depth`` calls earlier (None while the pipeline fills). Each leaf is
    staged through one of ``depth + 1`` pinned buffers per leaf position,
    so packing batch N+1 overlaps the H2D copy of batch N — the
    reference's pinned-buffer + async-memcpy + stream-sync-callback
    pattern (Tasks.cpp:617-662). A returned batch's copies are complete
    (the host waited on their events, where the JAX package called
    ``jax.block_until_ready``)."""

    def __init__(self, device=None, depth: int = 2):
        self.device = resolve_device(device)
        self.depth = max(1, depth)
        self._slots: list = []  # per put index mod depth+1: a Staging
        self._k = 0
        self._inflight: list = []  # (tree of tensors, copy event | None)

    def _stage(self, host_batch):
        slot_i = self._k % (self.depth + 1)
        self._k += 1
        if slot_i == len(self._slots):
            self._slots.append(Staging(self.device))
        staging = self._slots[slot_i]
        dev = iter(staging.upload(
            [torch.from_numpy(np.ascontiguousarray(a))
             for a in _leaves(host_batch)]))
        return _tree_map(lambda a: next(dev), host_batch), staging.barrier

    def put(self, host_batch) -> Optional[object]:
        with trace_range("UploadBuffer"):
            self._inflight.append(self._stage(host_batch))
        if len(self._inflight) > self.depth:
            return self._finish(self._inflight.pop(0))
        return None

    @staticmethod
    def _finish(item):
        tree, uploaded = item
        if uploaded is not None:
            uploaded.synchronize()
        return tree

    def drain(self):
        while self._inflight:
            yield self._finish(self._inflight.pop(0))
