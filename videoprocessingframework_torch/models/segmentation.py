"""Semantic segmentation: FCN head over ResNet bottleneck stages — the
counterpart of the JAX package's Flax ``models/segmentation.py``, with the
same module names.

Unlike :class:`~.resnet.ResNet`, the stem is a 7×7 stride-2 convolution
with symmetric padding 3 and no max-pool. The head is a float32 1×1
convolution with a bias, then a bilinear upsample to the input size by
the package's own resize matrices (``ops/resize.py:resize_matrix``): two
float32 matmuls, rows then columns, in full float32 (TF32 refused on the
card), as the JAX package's ``precision="highest"`` einsums.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_matrix
from ..utils.device import check_f32_matmul
from .resnet import BatchNorm, BottleneckBlock


@lru_cache(maxsize=16)
def _upsample_matrix(n_in: int, n_out: int, device: torch.device):
    """(n_out, n_in) bilinear matrix, uploaded once per size and device."""
    return torch.from_numpy(resize_matrix(n_in, n_out, "bilinear")).to(device)


class FCNResNet(nn.Module):
    def __init__(self, num_classes: int = 21,
                 stage_sizes: Sequence[int] = (2, 2, 2), width: int = 32,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(width, dtype)
        cin = width
        self.blocks = []
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = width * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, BottleneckBlock(cin, filters, stride,
                                                      dtype))
                self.blocks.append(name)
                cin = filters * 4
        self.classifier = nn.Conv2d(cin, num_classes, 1)

    def forward(self, x):
        """(N, H, W, 3) → (N, H, W, num_classes) float32 logits."""
        n, h, w, _ = x.shape
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.stem.weight.to(dt), None, 2, 3)
        x = F.relu(self.stem_bn(x))
        for name in self.blocks:
            x = getattr(self, name)(x)
        logits = self.classifier(x.float())  # (N, C, h', w')
        check_f32_matmul(logits, "FCNResNet's upsample")
        hr = _upsample_matrix(logits.shape[2], h, logits.device)
        wr = _upsample_matrix(logits.shape[3], w, logits.device)
        out = torch.matmul(torch.matmul(hr, logits), wr.T)
        return out.permute(0, 2, 3, 1)


def fcn_resnet(num_classes: int = 21, dtype=torch.bfloat16) -> FCNResNet:
    return FCNResNet(num_classes=num_classes, dtype=dtype)
