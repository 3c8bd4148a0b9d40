"""Training-side data loading: clip sampling over video corpora, decoded
on the host and post-processed on the device (the fused CUDA kernel, or
the augmenting pipeline); MJPEG corpora through the split codec."""

from ..ops.augment import AugmentSpec
from .bucketed import BucketedClipLoader
from .loader import ClipSampler, HostClipLoader, VideoClipLoader, VideoCorpus
from .mjpeg import MjpegClipLoader

__all__ = [
    "AugmentSpec",
    "BucketedClipLoader",
    "ClipSampler",
    "HostClipLoader",
    "MjpegClipLoader",
    "VideoClipLoader",
    "VideoCorpus",
]
