"""Bundled models, weight conversion and checkpoints."""

from .checkpoint import load_checkpoint, save_checkpoint
from .resnet import ResNet, resnet18_like, resnet50
from .segmentation import FCNResNet, fcn_resnet
from .video import VideoClassifier, video_resnet18_like, video_resnet50
from .vit import (
    ViT,
    VideoViT,
    video_vit_small,
    video_vit_tiny,
    vit_small,
    vit_tiny,
)
from .weights import from_jax_variables, load_torch_resnet50

__all__ = [
    "FCNResNet",
    "ResNet",
    "VideoClassifier",
    "VideoViT",
    "ViT",
    "fcn_resnet",
    "from_jax_variables",
    "load_checkpoint",
    "load_torch_resnet50",
    "resnet18_like",
    "resnet50",
    "save_checkpoint",
    "video_resnet18_like",
    "video_resnet50",
    "video_vit_small",
    "video_vit_tiny",
    "vit_small",
    "vit_tiny",
]
