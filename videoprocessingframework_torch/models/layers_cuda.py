"""The model layer's hand-written CUDA kernels: LayerNorm
(``csrc/layer_norm.cu``) and MoonViT's 2-D RoPE of the queries and keys
(``csrc/rope2d.cu``), their wrappers and the rule that picks them.

Neither replaces a Pallas kernel: the JAX package leaves LayerNorm to
XLA, which fuses it into one pass, and has no RoPE. The port's plain versions
stay where they were, in the modules that call these wrappers
(:class:`~.vit.LayerNorm`'s float32 chain and :func:`~.moonvit.rope2d`);
each sends a float32 copy of its rows through device memory twice,
where the kernels read the working type, keep float32 in registers and
store once. Both are bound by bytes (see the sources' notes).

Dispatch (:func:`takes_kernel`): a call launches a kernel where its
input is a plain CUDA tensor, no gradient is needed (grad mode is off,
or neither the input nor a parameter requires grad) and no
``torch.compile``/``torch.export``/JIT trace is open; every other call,
the CPU's and training's included, takes the plain version. Both kernels
take float32, bfloat16, float16 and float64; LayerNorm any width, row
stride and alignment. A call the kernel does not take (another dtype;
for RoPE, a head_dim that is not a multiple of 4 or a misaligned view,
which no MoonViT makes) raises.

The launches are made and counted by ``csrc/launch.py`` (``layer_norm``
and ``rope2d``), whose :func:`~..csrc.launch.counting` MoonViT's
``vision_stats`` read.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..csrc.launch import launch, ptr

#: the kernels' dtype codes (``csrc/vec_io.cuh``)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           torch.float64: 3}


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: grad mode is
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def takes_kernel(x, *params) -> bool:
    """Whether a call on ``x`` (with ``params``) launches the kernel:
    ``x`` a plain CUDA tensor, no gradient needed, no trace open."""
    if type(x) is not torch.Tensor or not x.is_cuda:
        return False
    if torch.compiler.is_compiling() or torch.jit.is_tracing():
        return False
    return not needs_grad(x, *params)


def _code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32, bfloat16, float16 or "
                         f"float64, got {dtype}")
    return _DTYPES[dtype]


def _aligned(n: int, *ints: int) -> bool:
    return all(i % n == 0 for i in ints)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of ``x`` (any leading shape) over its last dimension
    with float32 statistics, ``weight`` and ``bias``; the result in
    ``out_dtype``, contiguous. Rows may lie a stride apart (ViT's
    class-token rows ``x[:, 0]``); a strided last dimension is first
    copied contiguous, in ``x``'s dtype."""
    d = x.shape[-1]
    xc, yc = _code(x.dtype), _code(out_dtype)
    g, b = weight.float().contiguous(), bias.float().contiguous()
    if g.shape != (d,) or b.shape != (d,) or g.device != x.device \
            or b.device != x.device:
        raise ValueError(f"weight and bias must be ({d},) on {x.device}")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    rows = x.reshape(-1, d)  # a view where the leading dims collapse
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    # a single row's stride is free: pass the width
    rs = rows.stride(0) if rows.shape[0] > 1 else d
    launch("layer_norm", x.device, ptr(rows), xc, rs, ptr(out), yc, ptr(g),
           ptr(b), rows.shape[0], d, float(eps))
    return out


def rope2d(qkv: torch.Tensor, freqs: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The queries and keys of the (N, L, 3, heads, head_dim) projection
    ``qkv`` (read in place) turned by ``freqs`` (L,
    head_dim/2) complex64: (q, k), each (N, L, heads, head_dim)
    contiguous in ``qkv``'s dtype, the layout
    :func:`~.moonvit.rope2d` returns. One launch for both."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"expected (N, L, 3, heads, head_dim), got "
                         f"{tuple(qkv.shape)}")
    n, length, _, heads, hd = qkv.shape
    code = _code(qkv.dtype)
    if hd % 4:
        raise ValueError(f"head_dim must be a multiple of 4, got {hd}")
    if freqs.dtype != torch.complex64 or tuple(freqs.shape) != (length,
                                                                hd // 2):
        raise ValueError(f"freqs must be ({length}, {hd // 2}) complex64, "
                         f"got {tuple(freqs.shape)} {freqs.dtype}")
    if freqs.device != qkv.device:
        raise ValueError("qkv and freqs must share one device")
    table = torch.view_as_real(freqs)
    if not table.is_contiguous() or not _aligned(16, table.data_ptr()):
        raise ValueError("freqs must be contiguous and 16-byte aligned")
    if qkv.stride(-1) != 1:
        raise ValueError("qkv's last dimension must be contiguous")
    strides = qkv.stride()[:4]
    vec = next((v for v in ((8, 4) if qkv.element_size() == 2 else (4,))
                if hd % v == 0 and _aligned(v, *strides)
                and _aligned(v * qkv.element_size(), qkv.data_ptr())), None)
    if vec is None:
        raise ValueError("qkv's base and strides must be aligned to 4 "
                         "elements")
    out = torch.empty((2, n, length, heads, hd), dtype=qkv.dtype,
                      device=qkv.device)
    if out.numel() == 0:
        return out[0], out[1]
    launch("rope2d", qkv.device, ptr(qkv), code, *strides, ptr(table),
           ptr(out), n, length, heads, hd, vec)
    return out[0], out[1]
