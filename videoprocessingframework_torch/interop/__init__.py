"""Host↔device transfers and zero-copy tensor export of Surfaces."""

from .dlpack import surface_planes, surface_to_torch, torch_to_surface
from .transfer import DoubleBufferedUploader, FrameUploader, SurfaceDownloader

__all__ = [
    "DoubleBufferedUploader",
    "FrameUploader",
    "SurfaceDownloader",
    "surface_planes",
    "surface_to_torch",
    "torch_to_surface",
]
