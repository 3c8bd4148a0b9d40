"""ResNet family as ``nn.Module``s — the counterpart of the JAX package's
Flax models (``models/resnet.py``), with the same module names so that
:func:`~.weights.from_jax_variables` maps one tree onto the other.

Layout and numerics follow the Flax model:

* Input is NHWC. ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor
  is a ``channels_last`` NCHW tensor, so the convolutions run on it
  without a copy (convert the model with
  ``.to(memory_format=torch.channels_last)`` to keep it so throughout).
* Flax's ``padding="SAME"`` pads a 3×3 stride-2 convolution of an even
  input by (0, 1), not (1, 1); :class:`SameConv2d` pads explicitly.
  The stem (3/3) and the max-pool (1/1) are symmetric as in torch.
* ``dtype`` is the compute type; parameters stay float32 (Flax's
  ``param_dtype``) and are cast in the forward pass. BatchNorm runs in
  inference mode with ε = 1e-5, in float32 on the compute-type input.
* Convolutions go to cuDNN; whether they may use TF32 is the caller's
  ``torch.backends.cudnn.allow_tf32`` choice (irrelevant in bf16).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class SameConv2d(nn.Conv2d):
    """Convolution with TensorFlow/Flax "SAME" padding: total padding
    ``max((ceil(n/s) − 1)·s + k − n, 0)``, the odd pixel at the
    bottom/right. Bias-free unless ``bias``."""

    def __init__(self, cin, cout, k, stride=1, dtype=torch.bfloat16,
                 bias=False):
        super().__init__(cin, cout, k, stride=stride, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        pads = []
        for n in (x.shape[-1], x.shape[-2]):
            total = max((math.ceil(n / s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, self.stride)


class BatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm (Flax momentum 0.9 = torch momentum 0.1)
    computing on float32 statistics and returning the compute type."""

    def __init__(self, c, dtype=torch.bfloat16):
        super().__init__(c, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            self.training, self.momentum, self.eps,
        ).to(self.compute_dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = SameConv2d(cin, filters, 1, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = SameConv2d(filters, filters, 3, stride, dtype=dtype)
        self.bn2 = BatchNorm(filters, dtype)
        self.conv3 = SameConv2d(filters, filters * 4, 1, dtype=dtype)
        self.bn3 = BatchNorm(filters * 4, dtype)
        nn.init.zeros_(self.bn3.weight)  # Flax's scale_init=zeros
        self.proj_conv = self.proj_bn = None
        if stride != 1 or cin != filters * 4:
            self.proj_conv = SameConv2d(cin, filters * 4, 1, stride,
                                        dtype=dtype)
            self.proj_bn = BatchNorm(filters * 4, dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.proj_conv is not None:
            residual = self.proj_bn(self.proj_conv(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(3, width, 7, stride=2, padding=3,
                                   bias=False)
        self.stem_bn = BatchNorm(width, dtype)
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = width * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(
                    f"stage{i + 1}_block{j + 1}",
                    BottleneckBlock(cin, filters, stride, dtype),
                )
                cin = filters * 4
        self.blocks = [n for n, _ in self.named_children()
                       if n.startswith("stage")]
        self.classifier = nn.Linear(cin, num_classes)

    def forward(self, x):
        """(N, H, W, 3) → (N, num_classes) float32 logits."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.stem_conv.weight.to(self.dtype), None, 2, 3)
        x = F.relu(self.stem_bn(x))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.classifier(x.float())


def resnet50(num_classes: int = 1000, dtype=torch.bfloat16) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                  dtype=dtype)


def resnet18_like(num_classes: int = 1000, dtype=torch.bfloat16) -> ResNet:
    """Small bottleneck variant for tests / dry runs."""
    return ResNet(stage_sizes=(2, 2, 2, 2), num_classes=num_classes,
                  width=16, dtype=dtype)
