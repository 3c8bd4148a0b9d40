"""Enums, plane geometry, metadata types and the Surface memory objects."""

from .enums import ColorRange, ColorSpace, PixelFormat
from .surface import HostBuffer, Surface, SurfacePlane

__all__ = ["ColorRange", "ColorSpace", "HostBuffer", "PixelFormat",
           "Surface", "SurfacePlane"]
