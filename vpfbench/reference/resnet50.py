"""Plain forward of ResNet-50 v1.5 (He et al., arXiv:1512.03385, Table 1;
torchvision ``resnet50``: the stride on the 3×3 convolution), in
inference mode, on a dict of weights.

Follows the port's published departures (listed under ``assumed`` in
``configs/resnet50.json``): TensorFlow/Flax "SAME" padding on the
bottleneck convolutions (a 3×3 stride-2 convolution of an even input pads
(0, 1)), the stem and the max-pool padded symmetrically (3 and 1),
BatchNorm ε 1e-5 on running statistics, input NHWC.

``cast`` is applied to both operands of every convolution and of the
classifier, and is the identity for the float32 reference; the
lower-precision control passes a rounding to fp8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _same(x, k: int, s: int):
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _bn(w, name, x, eps=1e-5):
    scale = w[f"{name}.weight"] / torch.sqrt(w[f"{name}.running_var"] + eps)
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def forward(w: dict, x: torch.Tensor, cfg: dict, cast=None) -> torch.Tensor:
    """(N, H, W, 3) float input → (N, num_classes) float32 logits."""
    cast = cast or (lambda t: t)

    def conv(name, x, stride=1, same=True):
        k = w[f"{name}.weight"]
        if same:
            return F.conv2d(cast(_same(x, k.shape[-1], stride)), cast(k),
                            None, stride)
        return F.conv2d(cast(x), cast(k), None, stride, k.shape[-1] // 2)

    x = x.float().permute(0, 3, 1, 2)
    x = F.relu(_bn(w, "stem_bn", conv("stem_conv", x, 2, same=False)))
    x = F.max_pool2d(x, 3, 2, 1)
    for i, n_blocks in enumerate(cfg["stage_sizes"]):
        for j in range(n_blocks):
            p = f"stage{i + 1}_block{j + 1}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(_bn(w, f"{p}.bn1", conv(f"{p}.conv1", x)))
            y = F.relu(_bn(w, f"{p}.bn2", conv(f"{p}.conv2", y, stride)))
            y = _bn(w, f"{p}.bn3", conv(f"{p}.conv3", y))
            if f"{p}.proj_conv.weight" in w:
                x = _bn(w, f"{p}.proj_bn", conv(f"{p}.proj_conv", x, stride))
            x = F.relu(x + y)
    pooled = x.mean(dim=(2, 3))
    return cast(pooled) @ cast(w["classifier.weight"]).T + w["classifier.bias"]
