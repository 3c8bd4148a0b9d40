"""Device ops: resize matrices, colour conversion, the fused pipeline, and
the device half of the split MJPEG codec (ops/jpeg.py)."""

from .jpeg import JpegDeviceEncoder, JpegDevicePipeline, JpegDeviceTranscoder

__all__ = ["JpegDeviceEncoder", "JpegDevicePipeline", "JpegDeviceTranscoder"]
