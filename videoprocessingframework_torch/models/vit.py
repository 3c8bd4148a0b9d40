"""Vision Transformer family — the counterpart of the JAX package's Flax
``models/vit.py``, with the same module names so that
:func:`~.weights.from_jax_variables` maps one tree onto the other.

Numerics follow Flax, not torch's defaults:

* LayerNorm has ε = 1e-6, takes its statistics in float32 and returns
  float32 (the Flax blocks use ``LayerNorm(dtype=float32)``); a CUDA call
  that needs no gradient runs it as one kernel (``csrc/layer_norm.cu``,
  :mod:`.layers_cuda`);
* GELU is the tanh form (``nn.gelu``'s default);
* attention (Flax ``MultiHeadDotProductAttention``): query, key and value
  projections to (heads, head_dim) with biases, the query divided by
  √head_dim rounded to the compute type, the softmax in the compute type,
  an output projection from (heads, head_dim) with a bias. It is plain
  torch ops, as the JAX package left it to XLA;
* ``dtype`` is the compute type; parameters stay float32 (``cls``,
  ``pos_embed`` and ``time_pos`` are cast in the forward pass), the
  residual stream is in the compute type, the final norm and the logits
  are float32.

Flax sizes ``pos_embed`` and ``time_pos`` from the first input it sees;
here the constructor takes ``image_size`` and ``frames`` instead.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import layers_cuda
from .graphed import GraphedModule
from .resnet import Float32Linear, SameConv2d


class Dense(nn.Linear):
    """Flax ``nn.Dense(dtype=...)``: input, kernel and bias in the compute
    type."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__(cin, cout)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm(dtype=float32)``: ε = 1e-6 unless ``eps``,
    input, scale and bias in float32, the result in ``out_dtype``.

    A CUDA call that needs no gradient launches the LayerNorm kernel
    (:func:`.layers_cuda.layer_norm`: the input read in its own dtype,
    float32 statistics in registers, one store in ``out_dtype``; any
    width, float32, bfloat16, float16 or float64 in and out), or raises
    on another dtype. Every other call runs the plain version below, the
    differentiable float32 chain: the CPU's, and the training steps'
    (``parallel/train.py``, ``sample_train_video``)."""

    def __init__(self, dim: int, out_dtype=torch.float32, eps: float = 1e-6):
        super().__init__(dim, eps=eps)
        self.out_dtype = out_dtype

    def forward(self, x):
        if layers_cuda.takes_kernel(x, self.weight, self.bias):
            return layers_cuda.layer_norm(x, self.weight, self.bias,
                                          self.eps, self.out_dtype)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.out_dtype)


class MultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention(num_heads, dtype)`` over
    (B, L, dim) queries and (B, S, dim) keys/values."""

    def __init__(self, dim: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.heads = heads
        self.dtype = dtype
        self.query = Dense(dim, dim, dtype)
        self.key = Dense(dim, dim, dtype)
        self.value = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def forward(self, q_in, kv_in):
        b, lq, dim = q_in.shape
        hd = dim // self.heads
        q = self.query(q_in).view(b, lq, self.heads, hd)
        k = self.key(kv_in).view(b, -1, self.heads, hd)
        v = self.value(kv_in).view(b, -1, self.heads, hd)
        # Flax divides by sqrt(depth) cast to the compute type (22.625 in
        # bf16 for head_dim 512)
        q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(
            self.dtype)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(o.reshape(b, lq, dim))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, dim * mlp_ratio, dtype)
        self.Dense_1 = Dense(dim * mlp_ratio, dim, dtype)

    def forward(self, x):
        y = self.LayerNorm_0(x)
        x = x + self.attn(y, y)
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(y)


class ViT(GraphedModule):
    """(N, H, W, 3) → (N, num_classes) float32 logits, or with
    ``head=False`` the (N, dim) normed CLS features."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 dim: int = 384, depth: int = 6, heads: int = 6,
                 dtype=torch.bfloat16, head: bool = True,
                 image_size: Sequence[int] = (224, 224)):
        super().__init__()
        self.dtype = dtype
        self.dim = dim
        self.depth = depth
        self.image_size = tuple(image_size)
        self.patchify = SameConv2d(3, dim, patch, patch, dtype=dtype,
                                   bias=True)
        tokens = 1 + math.prod(-(-n // patch) for n in self.image_size)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, tokens, dim))
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, heads, dtype=dtype))
        self.LayerNorm_0 = LayerNorm(dim)
        self.classifier = Float32Linear(dim, num_classes) if head else None

    def forward(self, x):
        if tuple(x.shape[1:3]) != self.image_size:
            raise ValueError(f"ViT built for {self.image_size} images, got "
                             f"{tuple(x.shape[1:3])}")
        return super().forward(x)

    def _forward(self, x):
        n, dt = x.shape[0], self.dtype
        x = self.patchify(x.to(dt).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (N, tokens, dim), row-major
        x = torch.cat([self.cls.to(dt).expand(n, -1, -1), x], 1)
        x = x + self.pos_embed.to(dt)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.LayerNorm_0(x[:, 0])
        if self.classifier is None:
            return x
        return self.classifier(x)


def vit_small(num_classes: int = 1000, dtype=torch.bfloat16,
              image_size=(224, 224)) -> ViT:
    return ViT(num_classes=num_classes, dtype=dtype, image_size=image_size)


def vit_tiny(num_classes: int = 1000, dtype=torch.bfloat16,
             image_size=(224, 224)) -> ViT:
    return ViT(num_classes=num_classes, dim=192, depth=4, heads=3,
               dtype=dtype, image_size=image_size)


class VideoViT(nn.Module):
    """Factorised space-time video transformer over ``[B, T, H, W, C]``
    clips: the image :class:`ViT` (under ``spatial``, no head) runs as one
    flat ``[B·T]`` batch, then a temporal transformer over the T
    per-frame CLS features. ``frames`` fixes T, as Flax's init did."""

    def __init__(self, num_classes: int = 400, patch: int = 16,
                 dim: int = 384, depth: int = 6, heads: int = 6,
                 temporal_depth: int = 2, dtype=torch.bfloat16,
                 frames: int = 8, image_size: Sequence[int] = (224, 224)):
        super().__init__()
        self.dtype = dtype
        self.dim = dim
        self.frames = frames
        self.temporal_depth = temporal_depth
        self.spatial = ViT(patch=patch, dim=dim, depth=depth, heads=heads,
                           dtype=dtype, head=False, image_size=image_size)
        self.time_pos = nn.Parameter(0.02 * torch.randn(1, frames, dim))
        self.time_cls = nn.Parameter(torch.zeros(1, 1, dim))
        for i in range(temporal_depth):
            self.add_module(f"tblock{i}", ViTBlock(dim, heads, dtype=dtype))
        self.LayerNorm_0 = LayerNorm(dim)
        self.classifier = Float32Linear(dim, num_classes)

    def forward(self, x):
        b, t = x.shape[:2]
        if t != self.frames:
            raise ValueError(f"VideoViT built for {self.frames}-frame clips, "
                             f"got {t}")
        dt = self.dtype
        feats = self.spatial(x.reshape((b * t,) + tuple(x.shape[2:])))
        z = feats.reshape(b, t, self.dim).to(dt) + self.time_pos.to(dt)
        z = torch.cat([self.time_cls.to(dt).expand(b, -1, -1), z], 1)
        for i in range(self.temporal_depth):
            z = getattr(self, f"tblock{i}")(z)
        return self.classifier(self.LayerNorm_0(z[:, 0]))


def video_vit_tiny(num_classes: int = 400, temporal_depth: int = 2,
                   dtype=torch.bfloat16, frames: int = 8,
                   image_size=(224, 224)) -> VideoViT:
    return VideoViT(num_classes=num_classes, dim=192, depth=4, heads=3,
                    temporal_depth=temporal_depth, dtype=dtype,
                    frames=frames, image_size=image_size)


def video_vit_small(num_classes: int = 400, dtype=torch.bfloat16,
                    frames: int = 8, image_size=(224, 224)) -> VideoViT:
    return VideoViT(num_classes=num_classes, dtype=dtype, frames=frames,
                    image_size=image_size)
