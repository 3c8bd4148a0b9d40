"""Multi-process scaling for the video pipeline — the counterpart of the
JAX package's ``parallel/multihost.py``.

Each rank (one a device, on any number of hosts) decodes its own streams
on its own CPUs; its packed frame batches become its shard of ONE global
batch, a ``DTensor`` sharded over ``data``. Frame data never leaves its
rank: a rank uploads only its own frames, and the per-frame
post-processing needs no collective.

    mesh = make_mesh(axes=("data",))           # spans every rank
    pipe = MultiHostVideoPipeline(local_sources, postproc, mesh=mesh)
    for out in pipe.batches():                 # out: a global DTensor
        ...

A world of one works the same way.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .mesh import (
    _tree_map,
    batch_sharding,
    make_mesh,
    mesh_device,
    place_local,
    wrap_local,
)

__all__ = ["GlobalBatchAssembler", "MultiHostVideoPipeline"]


class GlobalBatchAssembler:
    """Each rank's local packed frames → one global ``DTensor`` sharded
    over ``axis``, placed on the rank's own device."""

    def __init__(self, mesh: Optional[DeviceMesh] = None,
                 axis: str = "data"):
        self.mesh = mesh or make_mesh(axes=(axis,))
        self.axis = axis
        self.sharding = batch_sharding(self.mesh, axis)
        self.device = mesh_device(self.mesh)

    @property
    def local_batch_multiple(self) -> int:
        """Local batches must be a multiple of this process's devices in
        the mesh: one, under one rank a device."""
        return 1

    def global_batch(self, local_packed):
        """This rank's packed batch (or a tuple of planes) as global
        ``DTensor``s; every rank's local batch must be the same size."""
        return _tree_map(lambda a: place_local(a, self.sharding),
                         local_packed)


class MultiHostVideoPipeline:
    """Per-rank native decode pool → global sharded batch → the
    post-processing on each rank's shard."""

    def __init__(
        self,
        local_sources: Sequence[str],
        postproc: Callable,
        mesh: Optional[DeviceMesh] = None,
        batch_size_per_host: int = 8,
        out_format=None,
        loop: bool = False,
        max_frames_per_stream: int = 0,
    ):
        from ..core.enums import PixelFormat
        from ..io.pool import NativeDecodePool

        self.assembler = GlobalBatchAssembler(mesh)
        self.postproc = postproc
        if batch_size_per_host % self.assembler.local_batch_multiple:
            raise ValueError(
                f"batch_size_per_host {batch_size_per_host} must divide by "
                f"the {self.assembler.local_batch_multiple} local devices")
        self.pool = NativeDecodePool(
            list(local_sources), batch_size=batch_size_per_host,
            out_format=(PixelFormat.YUV420 if out_format is None
                        else out_format),
            loop=loop, max_frames_per_stream=max_frames_per_stream,
            device=self.assembler.device)
        self.frames_local = 0

    def _every_rank(self, ok: bool) -> bool:
        """True when ``ok`` holds on every rank (one small all-reduce)."""
        flag = torch.tensor([int(ok)], dtype=torch.int32,
                            device=self.assembler.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    def batches(self) -> Iterator[DTensor]:
        """Yield globally sharded post-processed batches. The ranks stay
        in lockstep: every rank yields a batch only while every rank has a
        full one, so a ragged tail, or a rank whose streams end first,
        ends every rank's iteration together."""
        batch_size = self.pool.batch_size
        sharding = self.assembler.sharding
        while True:
            local = self.pool.acquire()
            full = local is not None and local.shape[0] == batch_size
            if not self._every_rank(full):
                if local is not None:
                    self.pool.release()
                return
            try:
                # the upload copies the slot (pinned staging on CUDA, a
                # copy on the CPU) before it returns: the slot is free
                g = self.assembler.global_batch(local)
            finally:
                self.pool.release()
            out = wrap_local(self.postproc(g.to_local()), sharding)
            self.frames_local += batch_size
            yield out

    def close(self) -> None:
        self.pool.close()
