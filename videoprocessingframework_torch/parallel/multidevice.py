"""Multi-device video pipelines — the counterpart of the JAX package's
``parallel/multidevice.py``.

* :class:`ShardedVideoPipeline` — one logical packed frame batch sharded
  over the mesh's ``data`` axis. Under one rank a device, every rank
  holds the same host batch, uploads only its own contiguous slice and
  runs the post-processing (a ``FusedPipeline``: the band kernel on the
  card) on it; the math is per frame, so no collective runs. The result
  is a ``DTensor`` sharded on dim 0.
* :class:`MultiDeviceStreamPipeline` — one process, decode batches fanned
  out round-robin over its devices (one post-processing call a device),
  the reference's pipeline-per-GPU.

Per-device results equal the single-device path bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.enums import PixelFormat
from ..utils.device import Staging, upload
from ..utils.tracing import StageTimer, trace_range
from .mesh import (
    _tree_map,
    batch_sharding,
    cuda_devices,
    make_mesh,
    mesh_device,
    shard_batch,
    wrap_local,
)

__all__ = ["MultiDeviceStreamPipeline", "ShardedVideoPipeline",
           "sharded_batch_matches_single_device"]


class ShardedVideoPipeline:
    """Shard a packed (B, rows, W) frame batch — or a plane-major ring's
    (y, u, v) planes, each (B, …) — over the mesh's data axis and run the
    fused post-processing on each rank's shard.

    ``postproc`` is a :class:`~..ops.fused.FusedPipeline` (or any callable
    over one packed batch, or over the planes) built for this rank's
    device. The batch dim must divide by the data axis; feed batches of
    ``per_rank_batch * ranks`` frames. Without ``mesh``, a mesh over the
    world on the postproc's device type.
    """

    def __init__(self, postproc: Callable,
                 mesh: Optional[DeviceMesh] = None, axis: str = "data"):
        if mesh is None:
            dev = getattr(postproc, "device", None)
            mesh = make_mesh(axes=(axis,), device_type=(
                "cuda" if dev is None else torch.device(dev).type))
        self.mesh = mesh
        self.axis = axis
        self.postproc = postproc
        self.sharding = batch_sharding(mesh, axis)

    @property
    def n_devices(self) -> int:
        return self.mesh.size()

    def __call__(self, batch):
        planes = tuple(batch) if isinstance(batch, (tuple, list)) else (
            batch,)
        b = planes[0].shape[0]
        n = self.sharding.batch_ranks
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} devices")
        with trace_range("ShardedFusedPostproc"):
            local = [p.to_local()
                     for p in shard_batch(planes, self.mesh, self.axis)]
            out = self.postproc(*local)
        return _tree_map(lambda o: wrap_local(o, self.sharding), out)


def _on(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class MultiDeviceStreamPipeline:
    """Fan independent stream batches out across devices round-robin.

    Wraps a :class:`~..io.pool.NativeDecodePool` over ``sources``; batch
    *k* goes to device ``k % n_devices`` (every ``cuda:<i>`` by default).
    Each device has its own pinned staging and side stream for the
    upload, and at most one dispatch in flight: the next device's upload
    starts while the previous device computes. ``postproc`` runs under
    ``torch.cuda.device(dev)``, so a ``FusedPipeline`` built with
    ``device="cuda"`` computes on each batch's own device.
    """

    def __init__(
        self,
        sources: Sequence[str],
        postproc: Callable,
        batch_size: int = 8,
        devices: Optional[Sequence] = None,
        out_format=None,
        loop: bool = False,
        max_frames_per_stream: int = 0,
    ):
        from ..io.pool import NativeDecodePool

        self.devices = [torch.device(d) for d in (
            devices if devices is not None else cuda_devices())]
        bound = getattr(postproc, "device", None)
        if (bound is not None and torch.device(bound).index is not None
                and len(set(self.devices)) > 1):
            raise ValueError(
                f"postproc is bound to {bound}; build it with device='cuda' "
                "so it computes on each batch's device")
        self.postproc = postproc
        self.timer = StageTimer("multidevice")
        # one buffer a device held in flight while the workers keep two to
        # fill (the pool releases FIFO)
        self._held_max = len(self.devices)
        fmt = PixelFormat.YUV420 if out_format is None else out_format
        # plane-major ring for YUV420 + a plane-aware postproc: each plane
        # of a batch is one contiguous block, so a batch uploads with no
        # host re-copy of strided views
        self._planar = (
            PixelFormat(fmt) == PixelFormat.YUV420
            and getattr(postproc, "src_format", None) == PixelFormat.YUV420
        )
        self.pool = NativeDecodePool(
            list(sources), batch_size=batch_size, out_format=fmt, loop=loop,
            max_frames_per_stream=max_frames_per_stream,
            n_buffers=self._held_max + 2, plane_major=self._planar,
            device=self.devices[0])
        self._stages = [Staging(d) for d in self.devices]
        self.frames = 0

    def _stage(self, i: int, host: list) -> list:
        """Host arrays → device ``i``: into the device's pinned staging
        buffers, then one non-blocking copy each on its side stream (the
        device's current stream waits on the copy's event). The staging
        buffers are free again: this device's previous dispatch was
        retired before this one."""
        staging = self._stages[i]
        src = [torch.from_numpy(np.ascontiguousarray(h)) for h in host]
        return upload(staging.stage(src), staging.device, staging.stream)[0]

    def batches(self) -> Iterator:
        """Yield device batches. Up to one dispatch a device stays
        outstanding; a pool slot is released (FIFO) only after its
        device's output event, so the decode workers refill it only once
        that device's staging buffer is free again."""
        pending = []  # (out, done event | None, frames) in acquire order
        k = 0
        flat_fn = None  # the single-transfer feed (pool.flat_postproc_fn)

        def retire():
            out, done, n = pending.pop(0)
            if done is not None:
                done.synchronize()
            self.pool.release()  # FIFO: the slot `out` was staged from
            self.frames += n
            return out

        try:
            while True:
                with self.timer.measure("acquire"):
                    if self._planar and flat_fn is not None:
                        got = self.pool.acquire_flat()
                    elif self._planar:
                        got = self.pool.acquire_planes()
                    else:
                        got = self.pool.acquire()
                if got is None:
                    break
                flat = None
                if self._planar and flat_fn is not None and not isinstance(
                        got, tuple):
                    flat, planes = got, ()
                elif self._planar:
                    planes = got
                else:
                    planes = (got,)
                i = k % len(self.devices)
                k += 1
                dev = self.devices[i]
                with self.timer.measure("dispatch"), _on(dev):
                    # full batches after the first ride the single-
                    # transfer flat feed (as NativeDecodePool.batches)
                    if flat is not None:
                        out = flat_fn(self._stage(i, [flat])[0])
                        n = self.pool.batch_size
                    else:
                        out = self.postproc(*self._stage(i, list(planes)))
                        n = planes[0].shape[0]
                        if self._planar and flat_fn is None:
                            flat_fn = self.pool.flat_postproc_fn(
                                self.postproc)
                    done = None
                    if dev.type == "cuda":
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(dev))
                pending.append((out, done, n))
                if len(pending) >= self._held_max:
                    yield retire()
            while pending:
                yield retire()
        finally:
            # an early close: wait for the devices, then free held slots
            for _, done, _ in pending:
                if done is not None:
                    done.synchronize()
                self.pool.release()
            pending.clear()

    def close(self) -> None:
        self.pool.close()


def sharded_batch_matches_single_device(
        postproc, batch, mesh: Optional[DeviceMesh] = None) -> bool:
    """Check helper: the sharded output equals the single-device output,
    bit for bit (``batch`` as :class:`ShardedVideoPipeline` takes it).
    Every rank returns the same verdict (the ranks' verdicts are
    all-reduced)."""
    pipe = ShardedVideoPipeline(postproc, mesh=mesh)
    multi = pipe(batch).full_tensor()
    planes = batch if isinstance(batch, (tuple, list)) else (batch,)
    single = postproc(*planes)
    same = (multi.shape == single.shape
            and bool(torch.equal(multi, single.to(multi.device))))
    verdict = torch.tensor([int(same)], dtype=torch.int32,
                           device=mesh_device(pipe.mesh))
    dist.all_reduce(verdict, op=dist.ReduceOp.MIN)
    return bool(verdict.item())
