"""Host I/O: the native libav runtime — demuxer, decoder and reader, the
decode pool, the encoder, the muxer and the transcoder — and the split
MJPEG codec's host half (the JPEG entropy coder, which needs no libav).
Importing builds nothing: each native library builds at first use."""

from .decoder import DecodedFrame, VideoDecoder, VideoReader, codec_caps
from .demuxer import DemuxResult, FFmpegDemuxer
from .encoder import VideoEncoder, get_encoder_params
from .jpeg import (
    JpegCoefDecoder,
    JpegCoefEncoder,
    JpegStreamError,
    MjpegReader,
    MjpegTranscoder,
    MjpegWriter,
)
from .muxer import StreamMuxer
from .pool import HostBatchRing, NativeDecodePool
from .transcode import TranscodeStats, Transcoder, transcode, transcode_many

__all__ = ["DecodedFrame", "DemuxResult", "FFmpegDemuxer", "HostBatchRing",
           "JpegCoefDecoder", "JpegCoefEncoder", "JpegStreamError",
           "MjpegReader", "MjpegTranscoder", "MjpegWriter",
           "NativeDecodePool", "StreamMuxer", "TranscodeStats", "Transcoder",
           "VideoDecoder", "VideoEncoder", "VideoReader", "codec_caps",
           "get_encoder_params", "transcode", "transcode_many"]
