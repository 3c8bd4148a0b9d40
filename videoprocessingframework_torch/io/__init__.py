"""Host I/O: the native libav runtime and the decode pool."""

from .pool import HostBatchRing, NativeDecodePool

__all__ = ["HostBatchRing", "NativeDecodePool"]
