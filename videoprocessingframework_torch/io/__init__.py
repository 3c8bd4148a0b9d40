"""Host I/O: the native libav runtime — demuxer, decoder and reader, and
the decode pool."""

from .decoder import DecodedFrame, VideoDecoder, VideoReader, codec_caps
from .demuxer import DemuxResult, FFmpegDemuxer
from .pool import HostBatchRing, NativeDecodePool

__all__ = ["DecodedFrame", "DemuxResult", "FFmpegDemuxer", "HostBatchRing",
           "NativeDecodePool", "VideoDecoder", "VideoReader", "codec_caps"]
