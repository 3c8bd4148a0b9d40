"""ViT-S/16 through the port's ``models.vit.ViT`` in bfloat16 at its
published depth of 12; its weights from the seed; its FLOPs a frame."""

from __future__ import annotations

from . import common


def _leaves(cfg):
    d, m, p = cfg["hidden_size"], cfg["mlp_dim"], cfg["patch_size"]
    tokens = 1 + (cfg["image_size"] // p) ** 2

    def dense(name, cin, cout):
        return [(f"{name}.weight", (cout, cin), common.normal(cin ** -0.5)),
                (f"{name}.bias", (cout,), common.normal(0.02))]

    def norm(name):
        return [(f"{name}.weight", (d,), common.around(1.0, 0.1)),
                (f"{name}.bias", (d,), common.normal(0.02))]

    leaves = [("patchify.weight", (d, 3, p, p),
               common.normal((3 * p * p) ** -0.5)),
              ("patchify.bias", (d,), common.normal(0.02)),
              ("cls", (1, 1, d), common.normal(1.0)),
              ("pos_embed", (1, tokens, d), common.normal(0.1))]
    for i in range(cfg["num_layers"]):
        b = f"block{i}"
        leaves += norm(f"{b}.LayerNorm_0")
        for s in ("query", "key", "value", "out"):
            leaves += dense(f"{b}.attn.{s}", d, d)
        leaves += norm(f"{b}.LayerNorm_1")
        leaves += dense(f"{b}.Dense_0", d, m) + dense(f"{b}.Dense_1", m, d)
    return leaves + norm("LayerNorm_0") + dense("classifier", d,
                                                 cfg["num_classes"])


def weights(cfg: dict, seed: int, device) -> dict:
    return common.make(_leaves(cfg), seed, device)


def build(cfg: dict, weights: dict):
    """The port's model on the weights' device, in inference mode."""
    import torch
    from videoprocessingframework_torch.models.vit import ViT

    if cfg["mlp_dim"] != 4 * cfg["hidden_size"] or not cfg["class_token"]:
        raise ValueError("the port's ViT has an MLP of 4x its width and a "
                         "class token")
    with torch.device("meta"):
        model = ViT(num_classes=cfg["num_classes"], patch=cfg["patch_size"],
                    dim=cfg["hidden_size"], depth=cfg["num_layers"],
                    heads=cfg["num_heads"],
                    dtype=common.DTYPES[cfg["dtype"]],
                    image_size=(cfg["image_size"], cfg["image_size"]))
    return common.load(model, weights)


def flops_per_frame(cfg: dict) -> float:
    """2 × the multiply-adds of the patch embedding, the projections, the
    attention scores and weighted values, the MLP and the classifier
    (norms, softmax, GELU and the residual sums are left out, as in the
    published 4.6 G)."""
    d, m, p = cfg["hidden_size"], cfg["mlp_dim"], cfg["patch_size"]
    patches = (cfg["image_size"] // p) ** 2
    t = patches + 1
    block = 4 * t * d * d + 2 * t * t * d + 2 * t * d * m
    macs = patches * 3 * p * p * d + cfg["num_layers"] * block \
        + d * cfg["num_classes"]
    return 2.0 * macs
