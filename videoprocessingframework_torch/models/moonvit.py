"""Kimi-VL's MoonViT vision tower with its projector (Kimi-VL Technical
Report, arXiv:2504.07491; the Kimi-VL-A3B-Instruct checkpoint's
config.json): normalised frames in, the visual tokens a language model
takes out.
MoonViT starts from SigLIP-so400m, whose widths the defaults are: patch
14, width 1152, 27 blocks, 16 heads of 72, MLP 4304, a 64×64 position
table, a 2×2 patch merge and a language model of width 2048.

Layer equations (pre-norm; LN is LayerNorm with ε 1e-5):

* x = Conv14×14/14(frame) + pos, with pos the learned table, bicubically
  interpolated to the patch grid when the grid is another size;
* each block: q, k, v = split(W_qkv·LN(x) + b); q, k ← RoPE2D(q, k);
  x += W_o·SDPA(q, k, v) + b over the frame's own patches (not causal,
  scale 1/√head_dim); x += W_2·gelu_tanh(W_1·LN(x) + b_1) + b_2;
* after the last block, LN; then each 2×2 block of the grid becomes one
  token of 4 parts in (row, col) order, and the projector takes LN of
  each part, Linear 4·dim → 4·dim, GELU (erf), Linear 4·dim → out_dim.

RoPE2D works per head: head_dim/4 frequencies f_i = θ^(−4i/head_dim),
θ = 10000; channel pairs (4i, 4i+1) turn by col·f_i and (4i+2, 4i+3) by
row·f_i, as complex products in float32. A CUDA call that needs no
gradient turns q and k in one kernel (:func:`.layers_cuda.rope2d`, read in
place from the QKV output, float32 in registers, stored in bf16);
:func:`rope2d` is the plain version, which every other call runs.

Numerics: parameters are float32 and products run in ``dtype`` (bf16)
through :class:`~.vit.Dense` and :class:`~.resnet.SameConv2d`; LayerNorm
takes float32 statistics (on CUDA in the kernel of :mod:`.layers_cuda`,
as RoPE); the residual stream is in ``dtype``; RoPE is float32; the
output is float32 (N, tokens, out_dim).

Attention is ``F.scaled_dot_product_attention`` on (N, heads, L,
head_dim) views. All frames of a call share one grid, so a batch is the
packed sequence of equal-length frames. On CUDA the first call takes the
first of :data:`SDPA_BACKENDS` that accepts its inputs and pins every
later call to it; ``math`` is not among them, so a call that no fused
kernel takes raises. The CPU runs whatever backend torch picks.

Spans (``utils/tracing.py``) inside the eager body, so they fire on eager
calls and during a capture while a replay stays inside ``model.graph``:
``model.patch_embed``, ``model.encoder`` (with ``model.attention`` around
each block's SDPA call) and ``model.merge`` (merge and projector).
:attr:`MoonViT.vision_stats` counts, on every call: ``patches`` and
``tokens`` a frame of the last call, ``pos_interpolations`` (calls whose
grid is not the table's) and ``attention_backend`` (the SDPA backend the
first CUDA call took); and, set by each eager call or capture (a replay
runs the captured launches again), ``norm_launches`` and
``rope_launches``, the LayerNorm and RoPE kernels that call launched
(:func:`..csrc.launch.counting`, so not another thread's): 2·depth + 2 and
depth on CUDA without gradients, 0 on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..csrc import launch
from ..utils.tracing import trace_range
from . import layers_cuda
from .graphed import GraphedModule
from .resnet import SameConv2d
from .vit import Dense, LayerNorm

#: fused SDPA backends a CUDA call may take, in the order tried: at
#: (8, 16, 4096, 72) bf16 on an H100 cuDNN's kernel took 1.66 ms, flash's
#: (a 96-wide head tile) 2.67 ms and the memory-efficient one 6.31 ms
SDPA_BACKENDS = (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                 SDPBackend.EFFICIENT_ATTENTION)


def rope_freqs(grid: Sequence[int], head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """(rows·cols, head_dim/2) complex64 turns of a row-major grid's
    positions: pair 2i by col·f_i, pair 2i+1 by row·f_i."""
    rows, cols = grid
    f = theta ** (-torch.arange(0, head_dim, 4, device=device,
                                dtype=torch.float32) / head_dim)
    pos = torch.arange(rows * cols, device=device)
    row, col = (pos // cols).float(), (pos % cols).float()
    angle = torch.stack([torch.outer(col, f), torch.outer(row, f)],
                        -1).flatten(1)
    return torch.polar(torch.ones_like(angle), angle)


def rope2d(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """(N, L, heads, head_dim) ``t`` with channel pairs turned by
    ``freqs`` (L, head_dim/2), in float32; the result in ``t``'s dtype."""
    n, length, heads, d = t.shape
    z = torch.view_as_complex(t.float().reshape(n, length, heads, d // 2, 2))
    return torch.view_as_real(z * freqs[:, None]).flatten(3).to(t.dtype)


def rope_qk(qkv: torch.Tensor, freqs: torch.Tensor):
    """(q, k) of the (N, L, 3, heads, head_dim) projection ``qkv``, each
    (N, L, heads, head_dim) turned by ``freqs``: one kernel launch for a
    CUDA call that needs no gradient, :func:`rope2d` on each otherwise."""
    if layers_cuda.takes_kernel(qkv):
        return layers_cuda.rope2d(qkv, freqs)
    return rope2d(qkv[:, :, 0], freqs), rope2d(qkv[:, :, 1], freqs)


def merge_patches(t: torch.Tensor, grid: Sequence[int],
                  merge: Sequence[int]) -> torch.Tensor:
    """(N, rows·cols, dim) row-major → (N, tokens, mh·mw, dim): each
    mh×mw block of the grid one token, its parts in (row, col) order, the
    tokens row-major."""
    n, _, d = t.shape
    (rows, cols), (mh, mw) = grid, merge
    t = t.view(n, rows // mh, mh, cols // mw, mw, d).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(n, (rows // mh) * (cols // mw), mh * mw, d)


class MoonViTBlock(nn.Module):
    """One pre-norm encoder block with 2-D RoPE on the queries and keys."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, eps: float,
                 dtype=torch.bfloat16):
        super().__init__()
        self.heads = heads
        self.norm0 = LayerNorm(dim, dtype, eps)
        self.wqkv = Dense(dim, 3 * dim, dtype)
        self.wo = Dense(dim, dim, dtype)
        self.norm1 = LayerNorm(dim, dtype, eps)
        self.fc0 = Dense(dim, mlp_dim, dtype)
        self.fc1 = Dense(mlp_dim, dim, dtype)

    def forward(self, x, freqs, attention):
        n, length, dim = x.shape
        qkv = self.wqkv(self.norm0(x)).view(n, length, 3, self.heads, -1)
        q, k = rope_qk(qkv, freqs)
        o = attention(q.transpose(1, 2), k.transpose(1, 2),
                      qkv[:, :, 2].transpose(1, 2))
        x = x + self.wo(o.transpose(1, 2).reshape(n, length, dim))
        y = F.gelu(self.fc0(self.norm1(x)), approximate="tanh")
        return x + self.fc1(y)


class MoonViT(GraphedModule):
    """(N, H, W, 3) normalised frames, H and W multiples of patch × merge,
    → (N, H·W / (patch² · mh·mw), out_dim) float32 visual tokens."""

    def __init__(self, patch: int = 14, dim: int = 1152, depth: int = 27,
                 heads: int = 16, mlp_dim: int = 4304,
                 pos_grid: Sequence[int] = (64, 64),
                 merge: Sequence[int] = (2, 2), out_dim: int = 2048,
                 eps: float = 1e-5, rope_theta: float = 10000.0,
                 dtype=torch.bfloat16):
        super().__init__()
        if dim % heads or (dim // heads) % 4:
            raise ValueError(f"width {dim} over {heads} heads must give a "
                             f"head size that is a multiple of 4")
        self.patch, self.dim, self.heads = patch, dim, heads
        self.pos_grid, self.merge = tuple(pos_grid), tuple(merge)
        self.rope_theta, self.dtype = rope_theta, dtype
        self.patch_embed = SameConv2d(3, dim, patch, patch, dtype=dtype,
                                      bias=True)
        self.pos_emb = nn.Parameter(0.02 * torch.randn(*self.pos_grid, dim))
        self.blocks = nn.ModuleList(
            MoonViTBlock(dim, heads, mlp_dim, eps, dtype)
            for _ in range(depth))
        self.final_layernorm = LayerNorm(dim, dtype, eps)
        merged = dim * self.merge[0] * self.merge[1]
        self.pre_norm = LayerNorm(dim, dtype, eps)
        self.linear_1 = Dense(merged, merged, dtype)
        self.linear_2 = Dense(merged, out_dim, dtype)
        self.vision_stats = {"patches": 0, "tokens": 0,
                             "pos_interpolations": 0,
                             "attention_backend": None,
                             "norm_launches": 0, "rope_launches": 0}
        self._backend = None  # the SDPA backend CUDA calls are pinned to

    def grid(self, shape: Sequence[int]) -> tuple:
        """The patch grid (rows, cols) of (N, H, W, 3) frames; raises
        where the sides do not split into whole patches and merges."""
        p, (mh, mw) = self.patch, self.merge
        if len(shape) != 4 or shape[3] != 3:
            raise ValueError(f"MoonViT takes (N, H, W, 3) frames, got "
                             f"{tuple(shape)}")
        if shape[1] % (p * mh) or shape[2] % (p * mw):
            raise ValueError(f"MoonViT takes sides that are multiples of "
                             f"{p * mh}×{p * mw} (patch {p}, merge "
                             f"{mh}×{mw}), got {shape[1]}×{shape[2]}")
        return shape[1] // p, shape[2] // p

    def forward(self, x):
        rows, cols = grid = self.grid(x.shape)
        s = self.vision_stats
        s["patches"] = rows * cols
        s["tokens"] = rows * cols // (self.merge[0] * self.merge[1])
        if grid != self.pos_grid:
            s["pos_interpolations"] += 1
        return super().forward(x)

    def _forward(self, x):
        with launch.counting() as launched:
            out = self._encode(x)
        s = self.vision_stats
        s["norm_launches"] = launched["layer_norm"]
        s["rope_launches"] = launched["rope2d"]
        return out

    def _encode(self, x):
        dt, grid = self.dtype, self.grid(x.shape)
        with trace_range("model.patch_embed"):
            t = self.patch_embed(x.to(dt).permute(0, 3, 1, 2))
            # (N, L, dim) in its own memory: the residual stream's adds and
            # norms then run on contiguous rows
            t = t.flatten(2).transpose(1, 2).contiguous()
            t = t + self._pos(grid).to(dt)
        with trace_range("model.encoder"):
            freqs = rope_freqs(grid, self.dim // self.heads, self.rope_theta,
                               x.device)
            for block in self.blocks:
                t = block(t, freqs, self._attention)
            t = self.final_layernorm(t)
        with trace_range("model.merge"):
            t = self.pre_norm(merge_patches(t, grid, self.merge)).flatten(2)
            return self.linear_2(F.gelu(self.linear_1(t))).float()

    def _pos(self, grid) -> torch.Tensor:
        """(rows·cols, dim) float32 position embeddings of the grid."""
        table = self.pos_emb.float()
        if grid != self.pos_grid:
            table = F.interpolate(table.permute(2, 0, 1)[None], size=grid,
                                  mode="bicubic",
                                  align_corners=False)[0].permute(1, 2, 0)
        return table.reshape(-1, self.dim)

    def _attention(self, q, k, v):
        with trace_range("model.attention"):
            if not q.is_cuda:
                return F.scaled_dot_product_attention(q, k, v)
            if self._backend is not None:
                with sdpa_kernel([self._backend]):
                    return F.scaled_dot_product_attention(q, k, v)
            refused = []
            for backend in SDPA_BACKENDS:
                try:
                    with sdpa_kernel([backend]):
                        out = F.scaled_dot_product_attention(q, k, v)
                except RuntimeError as e:  # this backend takes no such call
                    refused.append(f"{backend.name}: {e}")
                    continue
                self._backend = backend
                self.vision_stats["attention_backend"] = backend.name.lower()
                return out
            raise RuntimeError(
                f"no fused SDPA backend takes {tuple(q.shape)} {q.dtype} "
                f"attention, and MoonViT does not fall back to math: "
                + "; ".join(refused))


def kimi_vl_moonvit(dtype=torch.bfloat16) -> MoonViT:
    """Kimi-VL-A3B's MoonViT tower and projector at the published widths
    and 27 blocks."""
    return MoonViT(dtype=dtype)
