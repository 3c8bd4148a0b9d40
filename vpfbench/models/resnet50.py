"""ResNet-50 v1.5 through the port's ``models.resnet.ResNet`` in
bfloat16, channels_last; its weights from the seed; its FLOPs a frame."""

from __future__ import annotations

import torch

from . import common


def _blocks(cfg):
    """(prefix, cin, filters, stride, projected) of each bottleneck."""
    cin, out = cfg["width"], []
    for i, n in enumerate(cfg["stage_sizes"]):
        filters = cfg["width"] * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            cout = filters * cfg["bottleneck_expansion"]
            out.append((f"stage{i + 1}_block{j + 1}", cin, filters, stride,
                        stride != 1 or cin != cout))
            cin = cout
    return out


def _leaves(cfg):
    def conv(name, cin, cout, k):
        return [(f"{name}.weight", (cout, cin, k, k),
                 common.normal((2.0 / (cin * k * k)) ** 0.5))]

    def bn(name, c, scale=(1.0, 0.1)):
        return [(f"{name}.weight", (c,), common.around(*scale)),
                (f"{name}.bias", (c,), common.normal(0.1)),
                (f"{name}.running_mean", (c,), common.normal(0.1)),
                (f"{name}.running_var", (c,), common.log_normal(0.2))]

    w = cfg["width"]
    leaves = conv("stem_conv", 3, w, cfg["stem_kernel"]) + bn("stem_bn", w)
    for p, cin, f, _stride, proj in _blocks(cfg):
        cout = f * cfg["bottleneck_expansion"]
        leaves += conv(f"{p}.conv1", cin, f, 1) + bn(f"{p}.bn1", f)
        leaves += conv(f"{p}.conv2", f, f, 3) + bn(f"{p}.bn2", f)
        # the residual branch's last scale away from zero, and small
        # enough that the sum over 16 blocks keeps its scale
        leaves += conv(f"{p}.conv3", f, cout, 1) + bn(f"{p}.bn3", cout,
                                                       (0.3, 0.05))
        if proj:
            leaves += conv(f"{p}.proj_conv", cin, cout, 1)
            leaves += bn(f"{p}.proj_bn", cout)
    c = cfg["width"] * 2 ** (len(cfg["stage_sizes"]) - 1) * \
        cfg["bottleneck_expansion"]
    leaves += [("classifier.weight", (cfg["num_classes"], c),
                common.normal(c ** -0.5)),
               ("classifier.bias", (cfg["num_classes"],), common.normal(0.01))]
    return leaves


def weights(cfg: dict, seed: int, device) -> dict:
    return common.make(_leaves(cfg), seed, device)


def build(cfg: dict, weights: dict):
    """The port's model on the weights' device, in inference mode."""
    from videoprocessingframework_torch.models.resnet import ResNet

    with torch.device("meta"):
        model = ResNet(stage_sizes=cfg["stage_sizes"],
                       num_classes=cfg["num_classes"], width=cfg["width"],
                       dtype=common.DTYPES[cfg["dtype"]])
    model = common.load(model, weights)
    return model.to(memory_format=torch.channels_last)


def flops_per_frame(cfg: dict) -> float:
    """2 × the multiply-adds of the convolutions and the classifier at
    ``image_size`` (BatchNorm, ReLU, pooling and the residual sums are
    left out, as in the published 4.1 G)."""
    s = cfg["image_size"]
    k = cfg["stem_kernel"]
    h = -(-s // 2)
    macs = h * h * cfg["width"] * 3 * k * k
    h = -(-h // 2)  # max-pool
    for _p, cin, f, stride, proj in _blocks(cfg):
        cout = f * cfg["bottleneck_expansion"]
        ho = -(-h // stride)
        macs += h * h * cin * f + ho * ho * f * f * 9 + ho * ho * f * cout
        if proj:
            macs += ho * ho * cin * cout
        h = ho
    c = cfg["width"] * 2 ** (len(cfg["stage_sizes"]) - 1) * \
        cfg["bottleneck_expansion"]
    macs += c * cfg["num_classes"]
    return 2.0 * macs
