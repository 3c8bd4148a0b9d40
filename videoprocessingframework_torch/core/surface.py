"""Surface / SurfacePlane / HostBuffer — the framework's memory objects.

Counterpart of the JAX package's ``core/surface.py`` (the reference's
memory layer, src/TC/inc/MemoryInterfaces.hpp:76-841):

* ``Surface``   — a frame: per-plane arrays plus format metadata. Plane
  geometry comes from one declarative table (:mod:`..core.geometry`);
  planes are tightly packed.
* ``SurfacePlane`` — a view of one plane.
* ``HostBuffer``  — host-side bytes (reference ``Buffer``), plain numpy.

Host planes are numpy arrays; device planes are ``torch.Tensor``s on an
explicit device (CUDA unless the caller passes ``"cpu"``).

Torch tensors are mutable where JAX arrays are not, so every operation
that returns a new Surface (:meth:`Surface.clone`, :meth:`Surface.crop`,
and :meth:`Surface.to_device` / :meth:`Surface.to_host` when they move
data) copies its planes: a write into the result never shows in the
source, nor the reverse. The in-place writers
(:meth:`SurfacePlane.import_from`, :meth:`Surface.copy_from`) say so.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import geometry
from .enums import PixelFormat
from ..utils import alloc as _alloc
from ..utils.device import resolve_device

ArrayLike = Union[np.ndarray, torch.Tensor]

_NP_DTYPE = {
    torch.uint8: np.dtype(np.uint8),
    torch.uint16: np.dtype(np.uint16),
    torch.float32: np.dtype(np.float32),
}
_TORCH_DTYPE = {v: k for k, v in _NP_DTYPE.items()}


def _is_device_array(a) -> bool:
    return isinstance(a, torch.Tensor)


def _np_dtype(a) -> np.dtype:
    if isinstance(a, torch.Tensor):
        if a.dtype not in _NP_DTYPE:
            raise ValueError(f"unsupported plane dtype {a.dtype}")
        return _NP_DTYPE[a.dtype]
    return np.dtype(a.dtype)


def _to_numpy(a: ArrayLike) -> np.ndarray:
    """A host copy of a plane (numpy planes are returned as they are)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True).numpy()
    return np.asarray(a)


def _to_tensor(a: ArrayLike, device: torch.device) -> torch.Tensor:
    """A copy of a plane on ``device`` (never an alias of ``a``)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device, copy=True)


def split_frame(flat: torch.Tensor, fmt: PixelFormat, width: int,
                height: int) -> List[torch.Tensor]:
    """Plane views of one tightly-packed frame held in a 1-D uint8 tensor
    (the wire format of :meth:`Surface.download`); no copy."""
    expected = geometry.host_frame_size(fmt, width, height)
    if flat.numel() != expected:
        raise ValueError(
            f"frame size {flat.numel()} != expected {expected} for "
            f"{PixelFormat(fmt).name} {width}x{height}"
        )
    planes, off = [], 0
    for i, shp in enumerate(geometry.plane_shapes(fmt, width, height)):
        dt = geometry.plane_dtype(fmt, i)
        n = shp[0] * shp[1] * dt.itemsize
        planes.append(flat[off: off + n].view(_TORCH_DTYPE[dt]).view(shp))
        off += n
    return planes


def packed_bytes(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """All planes as one tightly-packed 1-D uint8 tensor on their device
    (one concatenation, so a download is one device-to-host copy)."""
    return torch.cat([p.contiguous().reshape(-1).view(torch.uint8)
                      for p in planes])


class HostBuffer:
    """Host memory token (reference ``Buffer``, MemoryInterfaces.hpp:76-116)."""

    __slots__ = ("data", "_alloc_id")

    def __init__(self, data: np.ndarray):
        self.data = np.ascontiguousarray(data)
        self._alloc_id = _alloc.register("HostBuffer", self.data.nbytes)

    @classmethod
    def make(cls, size: int) -> "HostBuffer":
        return cls(np.zeros(size, dtype=np.uint8))

    @classmethod
    def from_bytes(cls, raw: bytes) -> "HostBuffer":
        return cls(np.frombuffer(raw, dtype=np.uint8).copy())

    def size(self) -> int:
        return self.data.nbytes

    def copy_from(self, other: "HostBuffer") -> None:
        if other.data.nbytes != self.data.nbytes:
            raise ValueError("HostBuffer.copy_from: size mismatch")
        np.copyto(self.data, other.data)

    def __del__(self):
        try:
            _alloc.unregister(getattr(self, "_alloc_id", None))
        except Exception:
            pass  # interpreter shutdown: alloc module may be gone


class SurfacePlane:
    """One plane of a Surface. Width is in samples (channels included).

    When created via :meth:`Surface.plane`, writes through
    :meth:`import_from` show in the owning Surface."""

    __slots__ = ("array", "_owner", "_index")

    def __init__(self, array: ArrayLike, owner=None, index: int = 0):
        self.array = array
        self._owner = owner
        self._index = index

    @property
    def width(self) -> int:
        return int(self.array.shape[-1])

    @property
    def height(self) -> int:
        return int(self.array.shape[-2])

    @property
    def elem_size(self) -> int:
        return int(_np_dtype(self.array).itemsize)

    @property
    def pitch(self) -> int:
        """Row stride in bytes. Always tightly packed here."""
        return self.width * self.elem_size

    @property
    def host_frame_size(self) -> int:
        return self.width * self.height * self.elem_size

    def export(self) -> np.ndarray:
        """Plane contents as a host numpy array (a copy for a device
        plane)."""
        return _to_numpy(self.array)

    def import_from(self, src: np.ndarray) -> "SurfacePlane":
        """Replace plane contents from host data.

        A device plane is written IN PLACE (``Tensor.copy_``): the owning
        Surface, and any other holder of the same tensor, sees the new
        contents. A host plane is replaced by a copy of ``src``, as in the
        JAX package, so a frame buffer it was a view of is left alone."""
        src = np.asarray(src, dtype=_np_dtype(self.array)).reshape(
            tuple(self.array.shape))
        if _is_device_array(self.array):
            self.array.copy_(torch.from_numpy(np.ascontiguousarray(src)))
        else:
            self.array = src.copy()
        if self._owner is not None:
            self._owner.planes[self._index] = self.array
        return self

    def __repr__(self) -> str:
        where = "device" if _is_device_array(self.array) else "host"
        return (
            f"SurfacePlane(width={self.width}, height={self.height}, "
            f"pitch={self.pitch}, elem_size={self.elem_size}, mem={where})"
        )


class Surface:
    """A video frame: per-plane arrays + format metadata.

    ``width``/``height`` are luma dimensions. ``planes[i]`` has the shape
    dictated by :data:`..core.geometry.PLANE_SPECS`.
    """

    __slots__ = ("format", "width", "height", "planes", "_alloc_id")

    def __init__(
        self,
        fmt: PixelFormat,
        width: int,
        height: int,
        planes: Sequence[ArrayLike],
    ):
        fmt = PixelFormat(fmt)
        expected = geometry.plane_shapes(fmt, width, height)
        if len(planes) != len(expected):
            raise ValueError(
                f"{fmt.name} needs {len(expected)} planes, got {len(planes)}"
            )
        for i, (p, shp) in enumerate(zip(planes, expected)):
            if tuple(p.shape[-2:]) != shp:
                raise ValueError(
                    f"plane {i} of {fmt.name} {width}x{height}: expected "
                    f"shape {shp}, got {tuple(p.shape)}"
                )
            want = geometry.plane_dtype(fmt, i)
            if _np_dtype(p) != want:
                raise ValueError(
                    f"plane {i} of {fmt.name}: expected dtype {want}, got {p.dtype}"
                )
        self.format = fmt
        self.width = int(width)
        self.height = int(height)
        self.planes = list(planes)
        self._alloc_id = _alloc.register(
            f"Surface[{fmt.name}]", geometry.host_frame_size(fmt, width, height)
        )

    # -- construction -----------------------------------------------------

    @classmethod
    def make(
        cls,
        fmt: PixelFormat,
        width: int,
        height: int,
        device: Optional[object] = None,
    ) -> "Surface":
        """Allocate a zero-filled surface of torch tensors on ``device``
        (CUDA by default; pass ``"cpu"`` for the CPU). A host (numpy)
        Surface comes from :meth:`from_host_frame` or the constructor."""
        geometry.validate_even_dims(fmt, width, height)
        dev = resolve_device(device)
        planes: List[ArrayLike] = [
            torch.zeros(shp, dtype=_TORCH_DTYPE[geometry.plane_dtype(fmt, i)],
                        device=dev)
            for i, shp in enumerate(geometry.plane_shapes(fmt, width, height))
        ]
        return cls(fmt, width, height, planes)

    @classmethod
    def from_host_frame(
        cls,
        frame: np.ndarray,
        fmt: PixelFormat,
        width: int,
        height: int,
    ) -> "Surface":
        """Build a host Surface from one tightly-packed frame buffer
        (the wire format used by the decoder and `download()`). Its planes
        are views of ``frame``."""
        flat = np.ascontiguousarray(frame).reshape(-1).view(np.uint8)
        expected = geometry.host_frame_size(fmt, width, height)
        if flat.nbytes != expected:
            raise ValueError(
                f"frame size {flat.nbytes} != expected {expected} for "
                f"{PixelFormat(fmt).name} {width}x{height}"
            )
        planes = []
        off = 0
        for i, shp in enumerate(geometry.plane_shapes(fmt, width, height)):
            dt = geometry.plane_dtype(fmt, i)
            n = shp[0] * shp[1] * dt.itemsize
            planes.append(flat[off : off + n].view(dt).reshape(shp))
            off += n
        return cls(fmt, width, height, planes)

    # -- metadata ----------------------------------------------------------

    @property
    def num_planes(self) -> int:
        return len(self.planes)

    @property
    def is_on_device(self) -> bool:
        return _is_device_array(self.planes[0])

    @property
    def host_size(self) -> int:
        return geometry.host_frame_size(self.format, self.width, self.height)

    def empty(self) -> bool:
        return self.width == 0 or self.height == 0

    def plane(self, i: int = 0) -> SurfacePlane:
        return SurfacePlane(self.planes[i], owner=self, index=i)

    # -- data movement -----------------------------------------------------

    def clone(self) -> "Surface":
        """Deep copy (``torch.clone`` on the device for device surfaces)."""
        if self.is_on_device:
            new = [torch.clone(p) for p in self.planes]
        else:
            new = [p.copy() for p in self.planes]
        return Surface(self.format, self.width, self.height, new)

    def copy_from(self, other: "Surface") -> None:
        """Write ``other``'s contents into this Surface's planes, in place
        (``Tensor.copy_`` for device planes, ``np.copyto`` for host)."""
        if (other.format, other.width, other.height) != (
            self.format,
            self.width,
            self.height,
        ):
            raise ValueError("Surface.copy_from: geometry mismatch")
        for dst, src in zip(self.planes, other.planes):
            if self.is_on_device:
                if isinstance(src, np.ndarray):
                    src = torch.from_numpy(np.ascontiguousarray(src))
                dst.copy_(src)
            else:
                np.copyto(dst, _to_numpy(src))

    def to_device(self, device=None) -> "Surface":
        """Copy the planes to ``device`` (CUDA by default; ``"cpu"`` for
        the CPU). A device Surface with ``device=None`` is returned as it
        is."""
        if self.is_on_device and device is None:
            return self
        dev = resolve_device(device)
        planes = [_to_tensor(p, dev) for p in self.planes]
        return Surface(self.format, self.width, self.height, planes)

    def to_host(self) -> "Surface":
        if not self.is_on_device:
            return self
        planes = [_to_numpy(p) for p in self.planes]
        return Surface(self.format, self.width, self.height, planes)

    def download(self) -> np.ndarray:
        """One tightly-packed host buffer (uint8) of all planes."""
        if self.is_on_device:
            return packed_bytes(self.planes).cpu().numpy()
        out = np.empty(self.host_size, dtype=np.uint8)
        off = 0
        for p in self.planes:
            b = np.ascontiguousarray(p).reshape(-1).view(np.uint8)
            out[off : off + b.nbytes] = b
            off += b.nbytes
        return out

    def crop(self, x: int, y: int, w: int, h: int) -> "Surface":
        """ROI copy (reference Surface.Crop, PySurface.cpp:403-441).

        x/y/w/h are luma coordinates; chroma ROIs scale per plane. Device
        slices are copied too: a torch slice is a view, and the crop must
        not alias its source.
        """
        geometry.validate_even_dims(self.format, w, h)
        specs = geometry.PLANE_SPECS[self.format]
        planes = []
        for spec, p in zip(specs, self.planes):
            py = (y * spec.height_num) // spec.height_den
            ph = (h * spec.height_num) // spec.height_den
            px = (x * spec.width_num) // spec.width_den * spec.channels
            pw = (w * spec.width_num) // spec.width_den * spec.channels
            sl = p[..., py : py + ph, px : px + pw]
            if isinstance(sl, np.ndarray):
                planes.append(sl.copy())
            else:
                planes.append(sl.clone(memory_format=torch.contiguous_format))
        return Surface(self.format, w, h, planes)

    def __repr__(self) -> str:
        where = "device" if self.is_on_device else "host"
        return (
            f"Surface(format={self.format.name}, width={self.width}, "
            f"height={self.height}, planes={self.num_planes}, mem={where})"
        )

    def __del__(self):
        try:
            _alloc.unregister(getattr(self, "_alloc_id", None))
        except Exception:
            pass  # interpreter shutdown: alloc module may be gone
