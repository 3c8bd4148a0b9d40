"""Enums and plane geometry."""

from .enums import ColorRange, ColorSpace, PixelFormat

__all__ = ["ColorRange", "ColorSpace", "PixelFormat"]
