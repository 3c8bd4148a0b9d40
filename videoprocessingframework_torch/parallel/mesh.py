"""Device mesh over ``torch.distributed`` — the counterpart of the JAX
package's ``parallel/mesh.py``.

JAX runs one controller over every device; PyTorch runs one process per
device (``torchrun --nproc-per-node=N``): rank r computes on
``cuda:<local rank>``, ``torch.distributed`` ties the ranks together, a
``DeviceMesh`` names the axes, and a ``DTensor`` describes a global
tensor by the shard each rank holds. The JAX functions map so:

* ``make_mesh`` — a ``DeviceMesh`` over the whole world (one rank a
  device). With no process group, it starts a world of one over a local
  store, so single-process code reads as it does with the JAX package;
* ``batch_sharding`` / ``replicated`` — a :class:`Sharding` record
  ``(mesh, placements)``: ``Shard(0)`` on the batch axis and
  ``Replicate()`` on the others, or ``Replicate()`` everywhere;
* ``shard_batch`` — every rank holds the same global host batch (as
  ``jax.device_put`` does across processes) and uploads only its own
  contiguous slice: pinned staging, one non-blocking copy on a side
  stream, a CUDA event as the barrier (``utils.device.upload``). The
  result is a ``DTensor`` sharded on dim 0;
* ``device_round_robin`` — single process, over the local CUDA devices.

Collectives run over ``mesh.get_group(axis)``: NCCL on the card, gloo on
the CPU.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.device import upload

__all__ = ["Sharding", "batch_sharding", "cuda_devices", "device_round_robin",
           "make_mesh", "map_shards", "mesh_device", "place_local",
           "replicated", "shard_batch", "wrap_local"]

#: how long a world of one waits on its store
_WORLD_TIMEOUT = timedelta(seconds=60)


def _local_cuda_index() -> int:
    """This rank's CUDA device: ``LOCAL_RANK`` (torchrun), else the rank
    modulo the visible devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % torch.cuda.device_count()


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("data", "model"),
    shape: Optional[Tuple[int, ...]] = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over the whole world, one rank a device.

    The default shape puts every rank on ``data`` (pure batch
    parallelism), the other axes 1. ``n_devices`` must equal the world
    size and ``prod(shape)`` must equal ``n_devices``: either mismatch
    raises ``ValueError`` (the JAX package can take the first n devices;
    here a mesh spans the world). ``device_type`` is ``"cuda"`` unless
    the caller asks for ``"cpu"``; CUDA raises without a GPU. Without an
    initialized process group it starts a world of one (NCCL for CUDA,
    gloo for the CPU) over a local store.
    """
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be cuda|cpu, got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device_type='cpu' to run on "
            "the CPU")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1,
            timeout=_WORLD_TIMEOUT)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"{n} devices asked of a world of {world} ranks: a mesh spans "
            "the whole world, one rank a device")
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name axes {axes}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if device_type == "cuda":
        torch.cuda.set_device(_local_cuda_index())
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclass(frozen=True)
class Sharding:
    """A global tensor's layout over a mesh: one placement a mesh axis
    (the part ``NamedSharding(mesh, spec)`` plays in the JAX package)."""

    mesh: DeviceMesh
    placements: Tuple

    @property
    def batch_ranks(self) -> int:
        """How many shards dim 0 is split into."""
        return math.prod(self.mesh.size(i)
                         for i, p in enumerate(self.placements)
                         if isinstance(p, Shard) and p.dim == 0)

    @property
    def batch_index(self) -> int:
        """This rank's shard of dim 0 (row-major over the sharded axes)."""
        idx = 0
        for i, p in enumerate(self.placements):
            if isinstance(p, Shard) and p.dim == 0:
                idx = idx * self.mesh.size(i) + self.mesh.get_local_rank(i)
        return idx


def _axis_index(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r}")
    return names.index(axis)


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> Sharding:
    """Layout of a leading-batch tensor: dim 0 sharded over ``axis``."""
    i = _axis_index(mesh, axis)
    return Sharding(mesh, tuple(Shard(0) if k == i else Replicate()
                                for k in range(mesh.ndim)))


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, tuple(Replicate() for _ in range(mesh.ndim)))


def _global_stride(local: torch.Tensor, shape: Sequence[int]) -> tuple:
    """Strides of a dense tensor of ``shape`` laid out in ``local``'s
    dimension order (a permuted view stays permuted)."""
    order = sorted(range(local.dim()), key=lambda d: -local.stride(d))
    stride, step = [0] * local.dim(), 1
    for d in reversed(order):
        stride[d] = step
        step *= int(shape[d])
    return tuple(stride)


def wrap_local(local: torch.Tensor, sharding: Sharding) -> DTensor:
    """This rank's batch shard as the global ``DTensor`` of ``sharding``
    (every rank's shard the same size; no collective)."""
    shape = (local.shape[0] * sharding.batch_ranks,) + tuple(local.shape[1:])
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_global_stride(local, shape))


def map_shards(fn, x: DTensor):
    """``fn`` (a per-frame function of a batch) on ``x``'s local shard;
    every tensor it returns is a ``DTensor`` with ``x``'s placements.
    ``x`` must be sharded on dim 0 only."""
    if any(isinstance(p, Shard) and p.dim != 0 for p in x.placements):
        raise ValueError(f"{x.placements}: only dim 0 may be sharded")
    sh = Sharding(x.device_mesh, tuple(x.placements))
    return _tree_map(lambda o: wrap_local(o, sh), fn(x.to_local()))


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy()
    return torch.from_numpy(a)


def _upload(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: host data through a pinned staging copy and one
    non-blocking copy on the device's side stream (the current stream
    waits on its event); on the CPU a copy, never a view of the
    caller's memory."""
    if t.device.type == "cuda":
        return t.to(dev)
    side = None
    if dev.type == "cuda":
        t = t.pin_memory()
        side = torch.cuda.Stream(dev)  # from the device's stream pool
    (staged,), _ = upload([t], dev, side)
    return staged


def place_local(local, sharding: Sharding) -> DTensor:
    """This rank's own batch (host data or a tensor) on this rank's
    device, as the global ``DTensor`` of ``sharding``: the frames never
    leave their rank (``make_array_from_process_local_data``)."""
    if isinstance(local, DTensor):
        return local
    dev = mesh_device(sharding.mesh)
    return wrap_local(_upload(_host_tensor(local), dev), sharding)


def _place(a, sharding: Sharding):
    if isinstance(a, DTensor):
        return a
    t = _host_tensor(a)
    n, i = sharding.batch_ranks, sharding.batch_index
    if t.dim() == 0 or t.shape[0] % n:
        raise ValueError(
            f"batch of {tuple(t.shape)[:1]} does not divide over the {n} "
            f"batch shards of {sharding.mesh.mesh_dim_names}")
    b = t.shape[0] // n
    return place_local(t[i * b:(i + 1) * b], sharding)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(arrays, mesh: DeviceMesh, axis: str = "data"):
    """Global host batches (numpy arrays or tensors, in any nesting of
    dicts, lists and tuples; every rank holds the same) → ``DTensor``s
    sharded on dim 0 over ``axis``. Each rank uploads only its own
    contiguous slice; a batch that does not divide raises
    ``ValueError``. ``DTensor`` leaves pass through."""
    sh = batch_sharding(mesh, axis)
    return _tree_map(lambda a: _place(a, sh), arrays)


def cuda_devices() -> list:
    """Every ``cuda:<i>`` this process sees; raises without one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass the devices (e.g. ['cpu'])")
    return [torch.device("cuda", i) for i in range(n)]


def device_round_robin(i: int, devices: Optional[Sequence] = None):
    devs = list(devices) if devices is not None else cuda_devices()
    return devs[i % len(devs)]
