"""Plain forward of ViT-S/16 (DeiT-S, Touvron et al., arXiv:2012.12877,
Table 1; timm ``vit_small_patch16_224``): patch 16, width 384, 12 blocks
of pre-norm attention with 6 heads and an MLP of 1536, a class token,
learned position embeddings, a final LayerNorm on the class token and a
linear classifier, on a dict of weights.

Follows the port's published departures (listed under ``assumed`` in
``configs/vit_s16.json``): LayerNorm ε 1e-6, GELU in its tanh form, the
patch embedding as a "SAME"-padded convolution (no padding at 224²),
input NHWC.

``cast`` is applied to both operands of every matrix product (the
projections, the scores, the weighted values, the MLP, the patch
embedding and the classifier), and is the identity for the float32
reference; the lower-precision control passes a rounding to fp8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def forward(w: dict, x: torch.Tensor, cfg: dict, cast=None) -> torch.Tensor:
    """(N, H, W, 3) float input → (N, num_classes) float32 logits."""
    cast = cast or (lambda t: t)
    dim, heads = cfg["hidden_size"], cfg["num_heads"]
    eps = cfg["layer_norm_eps"]
    hd = dim // heads

    def dense(name, t):
        return cast(t) @ cast(w[f"{name}.weight"]).T + w[f"{name}.bias"]

    def norm(name, t):
        return F.layer_norm(t, (dim,), w[f"{name}.weight"], w[f"{name}.bias"],
                            eps)

    n = x.shape[0]
    t = F.conv2d(cast(x.float().permute(0, 3, 1, 2)),
                 cast(w["patchify.weight"]), w["patchify.bias"],
                 cfg["patch_size"])
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([w["cls"].expand(n, -1, -1), t], 1) + w["pos_embed"]
    for i in range(cfg["num_layers"]):
        p = f"block{i}"
        y = norm(f"{p}.LayerNorm_0", t)
        q, k, v = (dense(f"{p}.attn.{s}", y).view(n, -1, heads, hd)
                   .transpose(1, 2) for s in ("query", "key", "value"))
        s = cast(q / hd ** 0.5) @ cast(k).transpose(-1, -2)
        o = cast(torch.softmax(s, -1)) @ cast(v)
        t = t + dense(f"{p}.attn.out", o.transpose(1, 2).reshape(n, -1, dim))
        y = F.gelu(dense(f"{p}.Dense_0", norm(f"{p}.LayerNorm_1", t)),
                   approximate="tanh")
        t = t + dense(f"{p}.Dense_1", y)
    return dense("classifier", norm("LayerNorm_0", t[:, 0]))
