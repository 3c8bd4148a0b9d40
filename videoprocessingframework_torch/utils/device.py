"""Device selection shared by the package's entry points."""

from __future__ import annotations

import ctypes
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, CUDA by default. Entry points never
    drop to the CPU silently: without a GPU they raise unless the caller
    asked for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def is_dtensor(x) -> bool:
    """``x`` is a ``torch.distributed`` ``DTensor`` (checked without
    importing ``torch.distributed.tensor``: without it, nothing is)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays on its own device; anything else (numpy, lists)
    goes to ``device`` (CUDA by default)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    # torch tensors are writable and take no negative strides: copy
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy()
    return torch.as_tensor(a, device=resolve_device(device))


def to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or numpy data) on ``device``. Host data goes to a
    CUDA device by a pinned non-blocking copy, so the host does not wait
    for the device's queued work."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def check_f32_matmul(x: torch.Tensor, what: str) -> None:
    """``what`` computes in full float32: refuse a CUDA tensor while TF32
    matmuls are allowed."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{what} computes in full float32: turn TF32 matmul off "
            "(torch.backends.cuda.matmul.allow_tf32 = False)"
        )


def upload(host: Sequence[torch.Tensor], device: torch.device,
           stream: Optional["torch.cuda.Stream"]) -> tuple:
    """Host tensors → ``device`` for the current stream: ``(tensors,
    uploaded)``.

    On CUDA (``stream`` a side stream) each tensor is one non-blocking
    copy on ``stream``; the current stream waits on the event
    ``uploaded``, which is also the host tensors' recycle barrier: they
    may be written again once it has completed. Pinned host tensors make
    the copies DMA straight from them. Without a stream (the CPU) the
    tensors are cloned, since a ring of ``from_numpy`` views would alias
    them, and ``uploaded`` is None.

    The loaders' discipline: the tensors are allocated on ``stream`` and
    recorded as used by the current stream, and the copies do not wait
    for the current stream's earlier work (:func:`upload_ordered` does),
    so a copy runs while the device computes on earlier batches. The
    ring feed takes it for the slots it copies in place from their
    page-locked memory (:func:`page_lock`); its staged fallback keeps
    :func:`upload_ordered`.
    """
    if stream is None:
        return [h.clone() for h in host], None
    cur = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        staged = [torch.empty(h.shape, dtype=h.dtype, device=device)
                  for h in host]
        for dst, src in zip(staged, host):
            dst.copy_(src, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(stream)
    cur.wait_event(uploaded)
    for t in staged:
        t.record_stream(cur)
    return staged, uploaded


def upload_ordered(host: Sequence[torch.Tensor], device: torch.device,
                   stream: Optional["torch.cuda.Stream"]) -> tuple:
    """:func:`upload` in the staging uploaders' discipline (and the ring
    feed's for a slot it could not page-lock): each tensor is allocated
    on the current stream, which frees it, and ``stream`` first waits
    for the current stream (so for the memory's earlier users). The
    copies therefore queue behind work already on the current stream
    and cannot overlap it."""
    if stream is None:
        return [h.clone() for h in host], None
    current = torch.cuda.current_stream(device)
    dev = [torch.empty(h.shape, dtype=h.dtype, device=device) for h in host]
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        for dst, src in zip(dev, host):
            dst.copy_(src, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(stream)
    current.wait_event(uploaded)
    return dev, uploaded


#: ``cudaErrorHostMemoryAlreadyRegistered``
_ALREADY_REGISTERED = 712


def _cuda_runtime():
    """The CUDA runtime library that PyTorch loaded, found in the
    process's global symbols, or None where it is not there."""
    try:
        lib = ctypes.CDLL(None)
        get_last_error = lib.cudaGetLastError
    except (OSError, AttributeError):
        return None
    get_last_error.argtypes = []
    get_last_error.restype = ctypes.c_int
    return lib


def page_lock(host: torch.Tensor) -> Optional[bool]:
    """Page-lock the memory of ``host`` (a flat CPU tensor) in place
    (``cudaHostRegister``), so that a non-blocking copy from it is one
    DMA that the host does not wait for.

    True: this call locked it; the caller unlocks it with
    :func:`page_unlock` before the memory is freed, and after the last
    copy from it. False: the whole range was locked already by another
    owner, who unlocks it. None: it stays pageable (the runtime refused,
    or PyTorch's runtime is not reachable to clear the refusal, which a
    later kernel launch check would raise otherwise).
    """
    runtime = _cuda_runtime()
    if runtime is None:
        return None
    rc = int(torch.cuda.cudart().cudaHostRegister(
        host.data_ptr(), host.numel() * host.element_size(), 0))
    if rc == 0:
        return True
    runtime.cudaGetLastError()
    if rc == _ALREADY_REGISTERED and host[:1].is_pinned() \
            and host[-1:].is_pinned():
        return False
    return None


def page_unlock(ptr: int) -> None:
    """Undo a :func:`page_lock` of the memory at ``ptr``. A range the
    runtime no longer holds is left as it is."""
    if int(torch.cuda.cudart().cudaHostUnregister(ptr)):
        _cuda_runtime().cudaGetLastError()


class Staging:
    """Pinned host buffers that host data passes through on its way to
    ``device`` (one a tensor), the side stream that copies them (from
    PyTorch's stream pool), and the barrier event before which they are
    not written again.

    :meth:`stage` waits on :attr:`barrier`, reallocates a buffer only
    where a tensor's shape or dtype changed, and copies the host tensors
    in; :meth:`upload` stages, uploads in :func:`upload_ordered`'s
    discipline and makes the copy's event the barrier. A caller may set
    a later event as the barrier (the ring feed sets the one after its
    post-processing). On the CPU nothing is pinned and there is no
    stream: :meth:`stage` returns the host tensors, :meth:`upload` clones
    them.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.bufs: list = []
        self.barrier: Optional["torch.cuda.Event"] = None

    def wait(self) -> None:
        """Block until the barrier has completed (the buffers are free)."""
        if self.barrier is not None:
            self.barrier.synchronize()
            self.barrier = None

    def stage(self, host: Sequence[torch.Tensor]) -> list:
        """``host`` copied into the pinned buffers, once they are free."""
        if self.stream is None:
            return list(host)
        self.wait()
        if len(self.bufs) != len(host) or any(
                b.shape != h.shape or b.dtype != h.dtype
                for b, h in zip(self.bufs, host)):
            self.bufs = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                         for h in host]
        for buf, h in zip(self.bufs, host):
            buf.copy_(h)
        return self.bufs

    def upload(self, host: Sequence[torch.Tensor]) -> list:
        """``host`` on the device, ordered before later work on the
        current stream."""
        dev, self.barrier = upload_ordered(self.stage(host), self.device,
                                           self.stream)
        return dev
