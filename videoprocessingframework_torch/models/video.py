"""Video (clip) models: temporal heads over the bundled 2-D backbone — the
counterpart of the JAX package's Flax ``models/video.py``, with the same
module names (the backbone under ``backbone``).

A ``[B, T, H, W, C]`` batch runs the per-frame :class:`~.resnet.ResNet`
as one flat ``[B·T]`` forward (its classifier, ``width·32`` wide, acts as
the embedding projection), then a temporal head aggregates the T frame
features in the compute type:

* ``"mean"`` averages them, ``"last"`` takes the last;
* ``"attention"``: a learned CLS query (tiled over the batch) attends over
  the features plus learned time positions (4 heads, Flax attention
  numerics, see :mod:`.vit`), a residual query, and a LayerNorm whose
  statistics are float32 and whose result is in the compute type.

The ``"attention"`` head's time positions fix the clip length
(``frames``), as Flax's init did.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ResNet
from .vit import LayerNorm, MultiHeadAttention

__all__ = ["VideoClassifier", "video_resnet50", "video_resnet18_like"]

TEMPORAL = ("mean", "last", "attention")


class VideoClassifier(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 400,
                 width: int = 64, temporal: str = "attention",
                 heads: int = 4, dtype=torch.bfloat16, frames: int = 8):
        super().__init__()
        if temporal not in TEMPORAL:
            raise ValueError(f"unknown temporal head {temporal!r}")
        self.temporal = temporal
        self.dtype = dtype
        self.frames = frames
        feat = width * 8 * 4  # stage-4 channels (bottleneck ×4)
        self.backbone = ResNet(stage_sizes, num_classes=feat, width=width,
                               dtype=dtype)
        if temporal == "attention":
            self.time_pos = nn.Parameter(0.02 * torch.randn(1, frames, feat))
            self.cls_query = nn.Parameter(0.02 * torch.randn(1, 1, feat))
            self.temporal_attn = MultiHeadAttention(feat, heads, dtype)
            self.temporal_ln = LayerNorm(feat, out_dtype=dtype)
        self.classifier = nn.Linear(feat, num_classes)

    def forward(self, clips):
        """(B, T, H, W, 3) → (B, num_classes) float32 logits."""
        if clips.dim() != 5:
            raise ValueError(
                f"VideoClassifier wants [B, T, H, W, C], got "
                f"{tuple(clips.shape)}"
            )
        b, t = clips.shape[:2]
        dt = self.dtype
        f = self.backbone(clips.reshape((b * t,) + tuple(clips.shape[2:])))
        f = f.reshape(b, t, -1).to(dt)
        if self.temporal == "mean":
            z = f.mean(dim=1)
        elif self.temporal == "last":
            z = f[:, -1]
        else:
            if t != self.frames:
                raise ValueError(f"attention head built for {self.frames}-"
                                 f"frame clips, got {t}")
            h = f + self.time_pos.to(dt)
            q = self.cls_query.to(dt).expand(b, -1, -1)
            z = self.temporal_attn(q, h)[:, 0] + q[:, 0]
            z = self.temporal_ln(z)
        return self.classifier(F.relu(z).float())


def video_resnet50(num_classes: int = 400, temporal: str = "attention",
                   dtype=torch.bfloat16, frames: int = 8) -> VideoClassifier:
    return VideoClassifier((3, 4, 6, 3), num_classes=num_classes,
                           temporal=temporal, dtype=dtype, frames=frames)


def video_resnet18_like(num_classes: int = 8, temporal: str = "attention",
                        dtype=torch.bfloat16,
                        frames: int = 8) -> VideoClassifier:
    """Small variant for tests / dry runs."""
    return VideoClassifier((2, 2, 2, 2), num_classes=num_classes, width=16,
                           temporal=temporal, dtype=dtype, frames=frames)
