"""Training-side data loading: clip sampling over video corpora, decoded
on the host and post-processed on the device (the fused CUDA kernel, or
the augmenting pipeline)."""

from ..ops.augment import AugmentSpec
from .bucketed import BucketedClipLoader
from .loader import ClipSampler, HostClipLoader, VideoClipLoader, VideoCorpus

__all__ = [
    "AugmentSpec",
    "BucketedClipLoader",
    "ClipSampler",
    "HostClipLoader",
    "VideoClipLoader",
    "VideoCorpus",
]
