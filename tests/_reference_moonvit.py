"""Plain float32 forward of Kimi-VL's MoonViT tower and projector for the
port's tests: torch operations on a dict of weights named as the port's
``MoonViT.state_dict()``, attention as an explicit softmax, RoPE from
cos/sin, the merge by index. It imports nothing of the port and no JAX.

``cfg``: ``patch``, ``dim``, ``depth``, ``heads``, ``pos_grid``,
``merge``, ``eps``, ``rope_theta``. Run it with TF32 off
(:func:`strict_float32`) where a card computes it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_float32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rope(t: torch.Tensor, rows: int, cols: int, theta: float) -> torch.Tensor:
    """(..., rows·cols, head_dim) turned pair by pair: pair (4i, 4i+1) by
    col·f_i, pair (4i+2, 4i+3) by row·f_i, f_i = θ^(−4i/head_dim)."""
    d = t.shape[-1]
    pos = torch.arange(rows * cols, dtype=torch.float64)
    row, col = (pos // cols)[:, None], (pos % cols)[:, None]
    f = theta ** (-4 * torch.arange(d // 4, dtype=torch.float64) / d)
    out = t.clone()
    for j, turn in ((0, col * f), (2, row * f)):
        c, s = (u.float().to(t.device) for u in (turn.cos(), turn.sin()))
        a, b = t[..., j::4], t[..., j + 1::4]
        out[..., j::4] = a * c - b * s
        out[..., j + 1::4] = a * s + b * c
    return out


def forward(w: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(N, H, W, 3) → (N, tokens, out_dim) float32."""
    p, dim, heads = cfg["patch"], cfg["dim"], cfg["heads"]
    eps, hd = cfg["eps"], dim // heads
    n, rows, cols = x.shape[0], x.shape[1] // p, x.shape[2] // p
    mh, mw = cfg["merge"]

    def dense(name, t):
        return t @ w[f"{name}.weight"].T + w[f"{name}.bias"]

    def norm(name, t):
        return F.layer_norm(t, (dim,), w[f"{name}.weight"],
                            w[f"{name}.bias"], eps)

    t = F.conv2d(x.float().permute(0, 3, 1, 2), w["patch_embed.weight"],
                 w["patch_embed.bias"], stride=p).flatten(2).transpose(1, 2)
    table = w["pos_emb"]
    if (rows, cols) != tuple(cfg["pos_grid"]):
        table = F.interpolate(table.permute(2, 0, 1)[None], size=(rows, cols),
                              mode="bicubic", align_corners=False)[0]
        table = table.permute(1, 2, 0)
    t = t + table.reshape(rows * cols, dim)
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        qkv = dense(f"{b}.wqkv", norm(f"{b}.norm0", t))
        q, k, v = (qkv[..., j * dim:(j + 1) * dim]
                   .reshape(n, -1, heads, hd).transpose(1, 2)
                   for j in range(3))
        q, k = (rope(z, rows, cols, cfg["rope_theta"]) for z in (q, k))
        s = (q @ k.transpose(-1, -2)) / hd ** 0.5
        o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(n, -1, dim)
        t = t + dense(f"{b}.wo", o)
        y = F.gelu(dense(f"{b}.fc0", norm(f"{b}.norm1", t)),
                   approximate="tanh")
        t = t + dense(f"{b}.fc1", y)
    t = norm("final_layernorm", t)
    # token (r, c) of the merged grid: parts (mh·r + i, mw·c + j), i, j in
    # (row, col) order
    idx = torch.tensor([[(mh * r + i) * cols + mw * c + j
                         for i in range(mh) for j in range(mw)]
                        for r in range(rows // mh) for c in range(cols // mw)])
    t = norm("pre_norm", t[:, idx]).flatten(2)
    return dense("linear_2", F.gelu(dense("linear_1", t)))
