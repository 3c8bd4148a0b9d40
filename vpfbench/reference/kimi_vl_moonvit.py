"""Plain forward of Kimi-VL-A3B's MoonViT vision tower and projector
(Kimi-VL Technical Report, arXiv:2504.07491; the widths of SigLIP-so400m,
``vision_config`` in ``configs/kimi_vl_moonvit.json``): a 14×14 stride-14
patch embedding plus the learned 64×64 position table (bicubically
interpolated to another grid), 27 pre-norm blocks of attention with 2-D
RoPE over the frame's own patches and a tanh-GELU MLP, a final LayerNorm,
the 2×2 merge in (row, col) order, and the projector (LayerNorm on each
part, Linear, erf-GELU, Linear to the language model's width), on a dict
of weights. It follows the departures listed under ``assumed`` in the
configuration.

Attention is an explicit softmax, one frame at a time (a frame's scores
are 16 × 4096² float32, 1.07 GB at 896²). RoPE comes from cos and sin of
angles computed in float64.

``cast`` is applied to both operands of every matrix product (the patch
embedding, the projections, the scores, the weighted values, the MLP and
the projector), and is the identity for the float32 reference; the
lower-precision control passes a rounding to fp8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _turns(rows, cols, head_dim, theta, device):
    """((cos, sin) by column, (cos, sin) by row), each (rows·cols,
    head_dim/4) float32: f_i = θ^(−4i/head_dim)."""
    pos = torch.arange(rows * cols, dtype=torch.float64)
    f = theta ** (-4 * torch.arange(head_dim // 4, dtype=torch.float64)
                  / head_dim)
    out = []
    for index in (pos % cols, pos // cols):
        angle = index[:, None] * f
        out.append((angle.cos().float().to(device),
                    angle.sin().float().to(device)))
    return out


def _rope(t, turns):
    """Channel pairs (4i, 4i+1) turned by the column's angle, (4i+2,
    4i+3) by the row's."""
    out = t.clone()
    for j, (c, s) in zip((0, 2), turns):
        a, b = t[..., j::4], t[..., j + 1::4]
        out[..., j::4] = a * c - b * s
        out[..., j + 1::4] = a * s + b * c
    return out


def forward(w: dict, x: torch.Tensor, cfg: dict, cast=None) -> torch.Tensor:
    """(N, H, W, 3) float input → (N, tokens·width) float32: each frame's
    visual tokens flattened to one row."""
    cast = cast or (lambda t: t)
    v = cfg["vision_config"]
    p, dim, heads = v["patch_size"], v["hidden_size"], v["num_attention_heads"]
    eps, hd = v["layer_norm_eps"], dim // heads
    mh, mw = v["merge_kernel_size"]
    n, rows, cols = x.shape[0], x.shape[1] // p, x.shape[2] // p

    def dense(name, t):
        return cast(t) @ cast(w[f"{name}.weight"]).T + w[f"{name}.bias"]

    def norm(name, t):
        return F.layer_norm(t, (dim,), w[f"{name}.weight"], w[f"{name}.bias"],
                            eps)

    def attend(q, k, val):
        s = cast(q / hd ** 0.5) @ cast(k).transpose(-1, -2)
        return cast(torch.softmax(s, -1)) @ cast(val)

    t = F.conv2d(cast(x.float().permute(0, 3, 1, 2)),
                 cast(w["patch_embed.weight"]), w["patch_embed.bias"], p)
    t = t.flatten(2).transpose(1, 2)
    table = w["pos_emb"]
    if (rows, cols) != tuple(table.shape[:2]):
        table = F.interpolate(table.permute(2, 0, 1)[None], size=(rows, cols),
                              mode="bicubic", align_corners=False)[0]
        table = table.permute(1, 2, 0)
    t = t + table.reshape(rows * cols, dim)
    turns = _turns(rows, cols, hd, v["rope_theta"], x.device)
    for i in range(v["num_hidden_layers"]):
        b = f"blocks.{i}"
        qkv = dense(f"{b}.wqkv", norm(f"{b}.norm0", t))
        q, k, val = (qkv[..., j * dim:(j + 1) * dim]
                     .reshape(n, -1, heads, hd).transpose(1, 2)
                     for j in range(3))
        q, k = _rope(q, turns), _rope(k, turns)
        o = torch.stack([attend(q[f], k[f], val[f]) for f in range(n)])
        t = t + dense(f"{b}.wo", o.transpose(1, 2).reshape(n, -1, dim))
        y = F.gelu(dense(f"{b}.fc0", norm(f"{b}.norm1", t)),
                   approximate="tanh")
        t = t + dense(f"{b}.fc1", y)
    t = norm("final_layernorm", t)
    # merged token (r, c): patches (mh·r + i, mw·c + j), (i, j) row-major
    idx = torch.tensor([[(mh * r + i) * cols + mw * c + j
                         for i in range(mh) for j in range(mw)]
                        for r in range(rows // mh) for c in range(cols // mw)],
                       device=x.device)
    t = norm("pre_norm", t[:, idx]).flatten(2)
    return dense("linear_2", F.gelu(dense("linear_1", t))).reshape(n, -1)
