"""Training augmentations on the device: random resized crop, horizontal
flip and colour jitter inside the decode post-processing, and batch-level
MixUp / CutMix — the counterpart of the JAX package's ``ops/augment.py``.

The geometric augmentations are the fused pipeline's linear algebra with
per-clip matrices: a crop is an interpolation matrix built over the crop
window (the construction of ``ops.resize.resize_matrix``, batched), a
flip reverses the output axis of the column matrix, and colour jitter is
per-clip affine colour math after the CSC (brightness/contrast/saturation
as blends against gray, hue as a rotation of the YIQ chroma plane). The
JAX package computes these products in XLA, not Pallas (per-clip matrices
rule its kernels out); here they are float32 ``torch.matmul`` with TF32
refused, like its ``precision="highest"``.

Sampling is split from application. The JAX package drew with
``jax.random`` inside its program; here a sampler draws the per-clip
params on the host from a generator seeded by :func:`counter_seed`, a pure
function of (seed, epoch, batch index), and the application functions
take the params dict. The stream of params is deterministic, resume-exact
and, with the loader's shard-unique batch index, decorrelated across
shards; it is not the JAX package's stream (threefry is not reproduced),
so the two packages agree given the same params, not the same seed.

Params are per clip and broadcast across its frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..utils.device import check_f32_matmul, resolve_device, to_device
from . import colorspace as cs
from .colorspace import f32
from .convert import _round_u8
from .fused import OUTPUTS, _as_tensor, unpack_yuv_planes
from .normalize import IMAGENET_MEAN, IMAGENET_STD

__all__ = [
    "AugmentPipeline", "AugmentSpec", "augment_postproc", "counter_seed",
    "mixup_cutmix", "sample_augment_params", "sample_mixup_params",
    "window_matrices",
]

# Rec.601 luma weights: the gray axis for saturation/contrast blends
_GRAY_W = (0.299, 0.587, 0.114)

# RGB -> YIQ (NTSC) for the linear hue rotation
_RGB2YIQ = np.array(
    [
        [0.299, 0.587, 0.114],
        [0.595716, -0.274453, -0.321263],
        [0.211456, -0.522591, 0.311135],
    ],
    dtype=np.float64,
)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ)

#: the params dict's keys, in the order of their host → device copy
PARAM_KEYS = ("y0", "x0", "ch", "cw", "flip", "brightness", "contrast",
              "saturation", "hue", "time_reverse")
MIXUP_KEYS = ("lam", "use_cut", "gate", "cy", "cx")
_BOOL_KEYS = {"flip", "time_reverse", "use_cut", "gate"}


@dataclass(frozen=True)
class AugmentSpec:
    """Per-clip augmentation configuration.

    crop        — random resized crop. Area fraction ~ U(crop_scale),
                  aspect ~ logU(crop_ratio); an infeasible sample is
                  clamped to the frame instead of re-drawn.
    hflip       — probability of a horizontal flip.
    brightness  — factor ~ U(max(0, 1-b), 1+b); 0 disables.
    contrast    — factor ~ U(max(0, 1-c), 1+c) blended against the
                  clip's mean gray level. 0 disables.
    saturation  — factor ~ U(max(0, 1-s), 1+s) blended against gray.
    hue         — rotation ~ U(-h, h) turns of the YIQ chroma plane
                  (h ≤ 0.5). 0 disables.
    time_reverse — probability of playing the clip backwards.

    Jitter applies in the fixed order brightness → contrast →
    saturation → hue.
    """

    crop: bool = True
    crop_scale: Tuple[float, float] = (0.3, 1.0)
    crop_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    hflip: float = 0.5
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    time_reverse: float = 0.0

    def __post_init__(self):
        lo, hi = self.crop_scale
        if not (0.0 < lo <= hi <= 1.0):
            raise ValueError(
                f"crop_scale must be 0 < lo <= hi <= 1: {self.crop_scale}")
        rlo, rhi = self.crop_ratio
        if not (0.0 < rlo <= rhi):
            raise ValueError(
                f"crop_ratio must be 0 < lo <= hi: {self.crop_ratio}")
        if not (0.0 <= self.hflip <= 1.0):
            raise ValueError(f"hflip must be a probability: {self.hflip}")
        for name in ("brightness", "contrast", "saturation"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"{name} must be >= 0")
        if not (0.0 <= self.hue <= 0.5):
            raise ValueError(f"hue must be in [0, 0.5] turns: {self.hue}")
        if not (0.0 <= self.time_reverse <= 1.0):
            raise ValueError(
                f"time_reverse must be a probability: {self.time_reverse}")

    @property
    def any_jitter(self) -> bool:
        return bool(self.brightness or self.contrast or self.saturation
                    or self.hue)


def counter_seed(seed: int, epoch: int, batch_index: int) -> int:
    """A 64-bit generator seed that is a pure function of the counter
    (each part taken mod 2**32, as the JAX package's uint32 counter)."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                 int(epoch) & 0xFFFFFFFF,
                                 int(batch_index) & 0xFFFFFFFF])
    return int(ss.generate_state(1, np.uint64)[0])


def sample_augment_params(batch: int, in_h: int, in_w: int,
                          spec: AugmentSpec,
                          generator: torch.Generator) -> dict:
    """Per-clip params on the CPU: crop boxes (y0, x0, ch, cw in luma
    pixels), flip mask, jitter factors, hue angle (radians) and the
    time-reverse mask, each [batch]. One uniform row per param is drawn
    whatever the spec enables, so enabling one augmentation leaves the
    others' draws as they were."""
    B = batch
    u = torch.rand((len(PARAM_KEYS), B), generator=generator,
                   dtype=torch.float32)

    def between(row, lo, hi):
        return lo + (hi - lo) * u[row]

    if spec.crop:
        area = between(0, *spec.crop_scale) * float(in_h * in_w)
        ratio = torch.exp(between(1, float(np.log(spec.crop_ratio[0])),
                                  float(np.log(spec.crop_ratio[1]))))
        cw = torch.clamp(torch.sqrt(area * ratio), max=float(in_w))
        ch = torch.clamp(torch.sqrt(area / ratio), max=float(in_h))
        x0 = u[2] * (in_w - cw)
        y0 = u[3] * (in_h - ch)
    else:
        ch = torch.full((B,), float(in_h))
        cw = torch.full((B,), float(in_w))
        y0 = x0 = torch.zeros(B)

    def factor(row, amt):
        if not amt:
            return torch.ones(B)
        return between(row, max(0.0, 1.0 - amt), 1.0 + amt)

    return {
        "y0": y0, "x0": x0, "ch": ch, "cw": cw,
        "flip": u[4] < spec.hflip,
        "brightness": factor(5, spec.brightness),
        "contrast": factor(6, spec.contrast),
        "saturation": factor(7, spec.saturation),
        "hue": (between(8, -spec.hue, spec.hue) * (2.0 * np.pi)
                if spec.hue else torch.zeros(B)),
        "time_reverse": u[9] < spec.time_reverse,
    }


def _on_device(params: dict, keys, device: torch.device) -> dict:
    """The params (numpy, lists or tensors) as float32/bool tensors on
    ``device``: one stacked host tensor and, on CUDA, one pinned
    non-blocking copy."""
    def row(v):
        t = v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
        return t.detach().to("cpu", torch.float32)

    packed = to_device(torch.stack([row(params[k]) for k in keys]), device)
    return {k: packed[i] > 0.5 if k in _BOOL_KEYS else packed[i]
            for i, k in enumerate(keys)}


def _const(values, device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``. ``torch.tensor(..., device=)``
    would wait for the device's queued work; this copy does not."""
    return to_device(torch.tensor(values, dtype=torch.float32), device)


def _kernel_weights(d, method: str):
    if method == "lanczos":
        w = torch.sinc(d) * torch.sinc(d / 3.0)
        return torch.where(d.abs() < 3.0, w, torch.zeros_like(w))
    if method == "bilinear":
        return torch.clamp(1.0 - d.abs(), min=0.0)
    raise ValueError(f"augment supports lanczos|bilinear, got {method!r}")


def window_matrices(start, length, n_in: int, n_out: int,
                    method: str) -> torch.Tensor:
    """Batched crop+resize interpolation matrices [B, n_out, n_in]
    float32 for windows ``start``/``length`` ([B] source pixels): the
    construction of ``ops.resize.resize_matrix`` (dst-pixel-centre
    mapping, taps clamped into the frame, rows normalised to 1), which is
    the case start=0, length=n_in."""
    a = 3 if method == "lanczos" else 1
    dev = start.device
    i = torch.arange(n_out, dtype=torch.float32, device=dev)
    scale = (length / n_out)[:, None]
    src = start[:, None] + (i[None, :] + 0.5) * scale - 0.5  # [B, n_out]
    k = torch.arange(n_in, dtype=torch.float32, device=dev)
    w = _kernel_weights(src[:, :, None] - k[None, None, :], method)
    # taps that fall off either edge are clamped into the edge pixels:
    # the tap range is [floor(src)-a+1, floor(src)+a], src ∈ (-0.5,
    # n_in-0.5), so up to ``a`` taps fall off each side
    left = torch.zeros_like(src)
    right = torch.zeros_like(src)
    for e in range(1, a + 1):
        left = left + _kernel_weights(src + float(e), method)
        right = right + _kernel_weights(src - float(n_in - 1 + e), method)
    w[:, :, 0] += left
    w[:, :, -1] += right
    return w / w.sum(-1, keepdim=True)


def _hue_matrices(theta: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] linear hue rotation: RGB → YIQ → rotate chroma → RGB."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    rot = torch.stack([torch.stack([o, z, z], -1),
                       torch.stack([z, c, -s], -1),
                       torch.stack([z, s, c], -1)], -2)
    t, tinv = _const(_RGB2YIQ, theta.device), _const(_YIQ2RGB, theta.device)
    return torch.matmul(torch.matmul(tinv, rot), t)


def _color_jitter(rgb: torch.Tensor, params: dict,
                  spec: AugmentSpec) -> torch.Tensor:
    """Jitter on [B, T, h, w, 3] float32 RGB in [0, 255], clamping after
    each enabled stage."""
    def bparam(name):
        return params[name][:, None, None, None, None]

    gray_w = _const(_GRAY_W, rgb.device)
    if spec.brightness:
        rgb = torch.clamp(rgb * bparam("brightness"), 0.0, 255.0)
    if spec.contrast:
        gray_mean = torch.matmul(rgb, gray_w).sum((2, 3)).mean(-1) / (
            rgb.shape[-3] * rgb.shape[-2])
        gm = gray_mean[:, None, None, None, None]
        rgb = torch.clamp((rgb - gm) * bparam("contrast") + gm, 0.0, 255.0)
    if spec.saturation:
        gray = torch.matmul(rgb, gray_w)[..., None]
        rgb = torch.clamp(gray + (rgb - gray) * bparam("saturation"), 0.0,
                          255.0)
    if spec.hue:
        hm = _hue_matrices(params["hue"])  # [B, 3, 3]
        rgb = torch.clamp(
            torch.matmul(rgb, hm.transpose(1, 2)[:, None, None]), 0.0, 255.0)
    return rgb


def _chroma_collapse_b(mat: torch.Tensor) -> torch.Tensor:
    """Batched chroma collapse: [B, o, n] → [B, o, n/2]."""
    b, o, n = mat.shape
    return mat.reshape(b, o, n // 2, 2).sum(-1)


def augment_postproc(*planes, params: dict, src_format: PixelFormat,
                     space: ColorSpace, rng: ColorRange, out_h: int,
                     out_w: int, method: str = "lanczos",
                     output: str = "normalized",
                     mean: Sequence[float] = tuple(IMAGENET_MEAN),
                     std: Sequence[float] = tuple(IMAGENET_STD),
                     spec: AugmentSpec = AugmentSpec(),
                     clip_len: int = 1) -> torch.Tensor:
    """Decode post-processing with the augmentations ``params`` describe
    (see :func:`sample_augment_params`), on the planes' device.

    Input planes are flat ``[B·clip_len, ...]`` in any layout of
    ``decode_postproc``; the output is flat too (NHWC, or NCHW for
    ``normalized_nchw``).
    """
    if method not in ("lanczos", "bilinear"):
        raise ValueError(f"augment supports lanczos|bilinear, got {method!r}")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output mode {output!r}")
    y, u, v, subsampled, sub_h = unpack_yuv_planes(PixelFormat(src_format),
                                                   planes)
    check_f32_matmul(y, "augment_postproc")
    dev = y.device
    n, T = y.shape[0], int(clip_len)
    if n % T:
        raise ValueError(
            f"flat batch of {n} frames is not divisible by clip_len={T}")
    B = n // T
    p = _on_device(params, PARAM_KEYS, dev)
    if p["y0"].shape != (B,):
        raise ValueError(f"params are for {p['y0'].shape[0]} clips, the "
                         f"batch holds {B}")
    in_h, in_w = y.shape[-2], y.shape[-1]

    rmat = window_matrices(p["y0"], p["ch"], in_h, out_h, method)
    cmat = window_matrices(p["x0"], p["cw"], in_w, out_w, method)
    # flip = reverse the output axis of the column matrix (crop, then
    # flip)
    cmat = torch.where(p["flip"][:, None, None], cmat.flip(1), cmat)

    def resize(x, rm, cm):  # flat [B·T, h, w] → [B, T, out_h, out_w]
        x = x.reshape(B, T, *x.shape[1:]).to(torch.float32)
        t = torch.matmul(x, cm.transpose(1, 2)[:, None])
        return torch.matmul(rm[:, None], t)

    yb = resize(y, rmat, cmat)
    if u is None:
        ub = vb = torch.full(yb.shape, 128.0, dtype=torch.float32, device=dev)
    elif subsampled:
        rc, cc = _chroma_collapse_b(rmat), _chroma_collapse_b(cmat)
        ub, vb = resize(u, rc, cc), resize(v, rc, cc)
    elif sub_h:
        cc = _chroma_collapse_b(cmat)
        ub, vb = resize(u, rmat, cc), resize(v, rmat, cc)
    else:
        ub, vb = resize(u, rmat, cmat), resize(v, rmat, cmat)

    m, off = cs.rgb_from_ycbcr_matrix(space, rng)
    ycc = torch.stack([yb, ub, vb], dim=-1) - _const(off, dev)
    rgb = torch.matmul(ycc, _const(m, dev).T)
    rgb = torch.clamp(rgb, 0.0, 255.0)
    if spec.any_jitter:
        rgb = _color_jitter(rgb, p, spec)
    if spec.time_reverse and T > 1:
        rgb = torch.where(p["time_reverse"][:, None, None, None, None],
                          rgb.flip(1), rgb)
    rgb = rgb.reshape(n, out_h, out_w, 3)

    if output == "rgb_u8":
        return _round_u8(rgb)
    x = torch.clamp(rgb * f32(1.0 / 255.0), 0.0, 1.0)
    if output == "rgb_f32":
        return x
    x = (x - _const(mean, dev)) * (1.0 / _const(std, dev))
    if output == "normalized_nchw":
        return torch.movedim(x, -1, 1)
    return x


def sample_mixup_params(batch: int, rng: np.random.Generator, *,
                        mixup_alpha: float = 0.2, cutmix_alpha: float = 1.0,
                        switch_prob: float = 0.5,
                        prob: float = 1.0) -> dict:
    """Per-sample MixUp/CutMix draws from a numpy generator (torch's Beta
    takes no generator): λ ~ Beta(α, α) of the op each sample runs, the
    CutMix switch, the gate, and the box centre as uniforms ``cy``/``cx``
    in [0, 1)."""
    if mixup_alpha <= 0 and cutmix_alpha <= 0:
        raise ValueError("need mixup_alpha > 0 or cutmix_alpha > 0")
    B = batch
    switch = rng.random(B)
    gate = rng.random(B) < prob
    cy, cx = rng.random(B), rng.random(B)

    def beta(a):
        return rng.beta(a, a, B) if a > 0 else np.ones(B)

    if cutmix_alpha > 0 and mixup_alpha > 0:
        use_cut = switch < switch_prob
    else:
        use_cut = np.full(B, cutmix_alpha > 0)
    lam = np.where(use_cut, beta(cutmix_alpha), beta(mixup_alpha))
    return {"lam": lam.astype(np.float32), "use_cut": use_cut, "gate": gate,
            "cy": cy.astype(np.float32), "cx": cx.astype(np.float32)}


def mixup_cutmix(x: torch.Tensor, labels: torch.Tensor, params: dict, *,
                 num_classes: int):
    """Batch-level MixUp/CutMix with the draws ``params`` holds (see
    :func:`sample_mixup_params`), on ``x``'s device.

    x: float batch, channels-last — [B, H, W, C] images or [B, T, H, W, C]
    clips (a clip mixes with the same partner/λ/box in every frame).
    labels: int [B]. Each sample pairs with the reversed batch. A CutMix
    box has area 1−λ, and λ is re-derived from the integer box so the soft
    label matches the pixels. Returns (mixed_x, soft_labels [B,
    num_classes] float32).
    """
    if x.dim() not in (4, 5):
        raise ValueError(
            f"mixup_cutmix expects [B,H,W,C] or [B,T,H,W,C], got "
            f"{tuple(x.shape)}")
    if not x.is_floating_point():
        raise ValueError(
            f"mixup_cutmix needs a float batch (e.g. the loader's "
            f"'normalized'/'rgb_f32' outputs), got dtype {x.dtype}")
    dev = x.device
    B = x.shape[0]
    H, W = x.shape[-3], x.shape[-2]
    p = _on_device(params, MIXUP_KEYS, dev)
    lam, use_cut, gate = p["lam"], p["use_cut"], p["gate"]
    xf = x.to(torch.float32)
    x2 = xf.flip(0)
    y1 = F.one_hot(to_device(labels, dev).long(), num_classes).to(
        torch.float32)
    y2 = y1.flip(0)

    cut = torch.sqrt(torch.clamp(1.0 - lam, min=0.0))
    bh, bw = torch.round(cut * H), torch.round(cut * W)
    cy, cx = torch.round(p["cy"] * H), torch.round(p["cx"] * W)
    t0 = torch.clamp(cy - bh / 2, 0, H)
    t1 = torch.clamp(cy + bh / 2, 0, H)
    l0 = torch.clamp(cx - bw / 2, 0, W)
    l1 = torch.clamp(cx + bw / 2, 0, W)
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    in_rows = (rows[None, :] >= t0[:, None]) & (rows[None, :] < t1[:, None])
    in_cols = (cols[None, :] >= l0[:, None]) & (cols[None, :] < l1[:, None])
    box = in_rows[:, :, None] & in_cols[:, None, :]  # [B, H, W]
    # 1 − count · fl(1/(H·W)) with one rounding (exact in float64, then
    # float32), as the JAX package's compiled program fuses it
    count = box.sum(dim=(1, 2)).to(torch.float64)
    lam_cut = (1.0 - count * f32(1.0 / (H * W))).to(torch.float32)

    shape = (B,) + (1,) * (x.dim() - 1)
    lam_b = lam.reshape(shape)
    boxb = box[:, None, :, :, None] if x.dim() == 5 else box[:, :, :, None]
    mixed = torch.where(use_cut.reshape(shape), torch.where(boxb, x2, xf),
                        lam_b * xf + (1.0 - lam_b) * x2)
    mixed = torch.where(gate.reshape(shape), mixed, xf)
    lam_eff = torch.where(gate, torch.where(use_cut, lam_cut, lam),
                          torch.ones_like(lam))
    soft = lam_eff[:, None] * y1 + (1.0 - lam_eff)[:, None] * y2
    return mixed.to(x.dtype), soft


class AugmentPipeline:
    """The augmenting counterpart of :class:`~.fused.FusedPipeline`: an
    :class:`AugmentSpec` and one output configuration bound in.

    ``pipe(*planes, epoch=e, batch_index=i)`` samples the per-clip params
    from a generator seeded by ``counter_seed(seed, e, i)`` and applies
    them; ``pipe(*planes, params=p)`` applies given params. Inputs are
    moved to ``device`` (CUDA by default; ``"cpu"`` for the CPU).
    """

    def __init__(self, src_format: PixelFormat, color_space: ColorSpace,
                 color_range: ColorRange, out_size: Tuple[int, int],
                 spec: AugmentSpec, clip_len: int = 1,
                 method: str = "lanczos", output: str = "normalized",
                 mean: Sequence[float] = tuple(IMAGENET_MEAN),
                 std: Sequence[float] = tuple(IMAGENET_STD), seed: int = 0,
                 device=None):
        if method not in ("lanczos", "bilinear"):
            raise ValueError(
                f"augment supports lanczos|bilinear, got {method!r}")
        if output not in OUTPUTS:
            raise ValueError(f"unknown output mode {output!r}")
        self.src_format = PixelFormat(src_format)
        self.space = ColorSpace(color_space)
        self.range = ColorRange(color_range)
        self.out_w, self.out_h = out_size
        self.spec = spec
        self.clip_len = int(clip_len)
        self.method = method
        self.output = output
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def sample(self, batch: int, in_h: int, in_w: int, epoch: int = 0,
               batch_index: int = 0) -> dict:
        """The params this pipeline applies at (epoch, batch_index)."""
        g = torch.Generator().manual_seed(
            counter_seed(self.seed, epoch, batch_index))
        return sample_augment_params(batch, in_h, in_w, self.spec, g)

    def __call__(self, *planes, params: Optional[dict] = None,
                 epoch: int = 0, batch_index: int = 0) -> torch.Tensor:
        planes = tuple(_as_tensor(p, self.device) for p in planes)
        if params is None:
            y = unpack_yuv_planes(self.src_format, planes)[0]
            params = self.sample(y.shape[0] // self.clip_len, y.shape[-2],
                                 y.shape[-1], epoch, batch_index)
        return augment_postproc(
            *planes, params=params, src_format=self.src_format,
            space=self.space, rng=self.range, out_h=self.out_h,
            out_w=self.out_w, method=self.method, output=self.output,
            mean=self.mean, std=self.std, spec=self.spec,
            clip_len=self.clip_len)
