"""The full-resolution NV12 / YUV420 → planar RGB kernel's plain versions
(``ops/csc_cuda.py``) against the JAX package's Pallas kernel in interpret
mode and the float64 golden.

* vs ``nv12_to_rgb_planar_pallas`` / ``yuv420_to_rgb_planar_pallas``
  (interpret=True) at 64×128, B=2, every supported space × range and
  swap: ≤1 code (XLA on the CPU may contract a product and a sum into an
  FMA, one rounding fewer than the port's separately rounded float32
  ops); the count of differing codes is reported.
* vs the float64 golden (``ops/golden.py``): ≤1 code, also at sizes the
  TPU kernel refuses (30×100, 270×482).
* On the card (marked ``cuda``): the kernel equals its plain version
  exactly, and launches once per call.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.core.enums import (
    ColorRange as JColorRange,
    ColorSpace as JColorSpace,
)
from videoprocessingframework_tpu.ops.pallas_kernels import (
    nv12_to_rgb_planar_pallas,
    yuv420_to_rgb_planar_pallas,
)
from videoprocessingframework_torch.core.enums import ColorRange, ColorSpace
from videoprocessingframework_torch.csrc import launch
from videoprocessingframework_torch.ops import csc_cuda, golden

CS, CR = ColorSpace, ColorRange
COMBOS = [(CS.BT_709, CR.MPEG), (CS.BT_709, CR.JPEG), (CS.BT_601, CR.JPEG),
          (CS.BT_601, CR.MPEG)]


def _yuv(b, h, w, seed):
    r = np.random.default_rng(seed)
    y = r.integers(0, 256, (b, h, w), np.uint8)
    u = r.integers(0, 256, (b, h // 2, w // 2), np.uint8)
    v = r.integers(0, 256, (b, h // 2, w // 2), np.uint8)
    uv = np.stack([u, v], -1).reshape(b, h // 2, w)
    return y, u, v, uv


def _t(*a):
    return tuple(torch.from_numpy(x) for x in a)


def _diff(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    return int(d.max()), int((d > 0).sum())


def _golden(y, u, v, space, rng, swap):
    """(B, 3, H, W) u8 from the float64 golden."""
    out = np.stack([golden.yuv420_to_rgb(y[i], u[i], v[i], space, rng)
                    for i in range(len(y))])
    out = np.moveaxis(out, -1, 1)
    return out[:, ::-1] if swap else out


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("space,rng", COMBOS)
def test_plain_matches_pallas_interpret_nv12(space, rng, swap):
    y, u, v, uv = _yuv(2, 64, 128, seed=int(space) * 10 + int(rng))
    got = csc_cuda.nv12_to_rgb_planar(*_t(y, uv), space=space, rng=rng,
                                      swap=swap)
    want = np.asarray(nv12_to_rgb_planar_pallas(
        y, uv, space=JColorSpace(int(space)), rng=JColorRange(int(rng)),
        swap=swap, interpret=True))
    assert got.shape == (2, 3, 64, 128) and got.dtype == torch.uint8
    worst, n_off = _diff(got.numpy(), want)
    assert worst <= 1, f"max diff {worst}, {n_off} codes differ"


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("space,rng", COMBOS)
def test_plain_matches_pallas_interpret_yuv420(space, rng, swap):
    y, u, v, _ = _yuv(2, 64, 128, seed=100 + int(space) * 10 + int(rng))
    got = csc_cuda.yuv420_to_rgb_planar(*_t(y, u, v), space=space, rng=rng,
                                        swap=swap)
    want = np.asarray(yuv420_to_rgb_planar_pallas(
        y, u, v, space=JColorSpace(int(space)), rng=JColorRange(int(rng)),
        swap=swap, interpret=True))
    worst, n_off = _diff(got.numpy(), want)
    assert worst <= 1, f"max diff {worst}, {n_off} codes differ"


@pytest.mark.parametrize("h,w", [(64, 128), (30, 100), (270, 482), (2, 2)])
@pytest.mark.parametrize("space,rng", COMBOS)
def test_plain_matches_golden(space, rng, h, w):
    """Within 1 code of the float64 golden, at tile-aligned sizes and at
    sizes the TPU kernel refuses (H%32, W%128)."""
    y, u, v, uv = _yuv(2, h, w, seed=h + w)
    want = _golden(y, u, v, space, rng, swap=False)
    for got in (
        csc_cuda.nv12_to_rgb_planar(*_t(y, uv), space=space, rng=rng),
        csc_cuda.yuv420_to_rgb_planar(*_t(y, u, v), space=space, rng=rng),
    ):
        assert _diff(got.numpy(), want)[0] <= 1


def test_nv12_and_planar_agree_exactly():
    y, u, v, uv = _yuv(3, 30, 100, seed=5)
    for swap in (False, True):
        a = csc_cuda.nv12_to_rgb_planar(*_t(y, uv), swap=swap)
        b = csc_cuda.yuv420_to_rgb_planar(*_t(y, u, v), swap=swap)
        assert torch.equal(a, b)
    assert torch.equal(
        csc_cuda.nv12_to_rgb_planar(*_t(y, uv), swap=True),
        csc_cuda.nv12_to_rgb_planar(*_t(y, uv)).flip(1))


def test_pallas_refuses_what_the_port_takes():
    """The TPU kernel's H%32 / W%128 tiling rule does not carry over."""
    y, _, _, uv = _yuv(1, 30, 100, seed=0)
    with pytest.raises(ValueError, match="pallas nv12 kernel"):
        nv12_to_rgb_planar_pallas(y, uv, interpret=True)
    assert csc_cuda.csc_cuda_supported(30, 100)
    assert csc_cuda.csc_cuda_supported(1080, 1920)
    assert not csc_cuda.csc_cuda_supported(31, 100)
    assert not csc_cuda.csc_cuda_supported(30, 101)


def test_wrapper_checks():
    y, u, v, uv = _t(*_yuv(1, 8, 16, seed=1))
    with pytest.raises(ValueError, match="uint8"):
        csc_cuda.nv12_to_rgb_planar(y.float(), uv)
    with pytest.raises(ValueError, match="chroma plane"):
        csc_cuda.nv12_to_rgb_planar(y, uv[:, :, :-2])
    with pytest.raises(ValueError, match="chroma plane"):
        csc_cuda.yuv420_to_rgb_planar(y, u, v[:, :-1])
    with pytest.raises(ValueError, match="even frame size"):
        csc_cuda.yuv420_to_rgb_planar(y[:, :7], u, v)
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        csc_cuda.nv12_to_rgb_planar(y[0], uv[0])


def test_column_width_choice():
    """The launch takes the widest of 8, 4, 2 luma columns a thread that
    the width and the planes' alignment allow as single loads."""
    def vec(h, w, step, offset=0):
        # rows padded by 8 bytes; CPU allocations are 64-byte aligned
        y = torch.zeros(2, h, w + 8, dtype=torch.uint8)
        y = y[..., offset:w + offset]
        c = torch.zeros(2, h // 2, (w // 2) * step + 8,
                        dtype=torch.uint8)[..., :(w // 2) * step]
        ptrs = (c.data_ptr(),) * (3 - step)
        return csc_cuda._vec(y, ptrs, c.stride(), step)

    assert vec(1080, 1920, 2) == 8 and vec(1080, 1920, 1) == 8
    assert vec(30, 100, 2) == 4 and vec(30, 100, 1) == 4
    assert vec(270, 482, 2) == 2 and vec(270, 482, 1) == 2
    assert vec(1080, 1920, 2, offset=4) == 4  # base only 4-byte aligned
    with pytest.raises(ValueError, match="2-byte aligned"):
        vec(1080, 1920, 1, offset=1)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper takes its plain version because the tensors lie on the
    CPU; no launch is counted."""
    y, _, _, uv = _t(*_yuv(1, 8, 16, seed=2))
    launch.reset_launches()
    got = csc_cuda.nv12_to_rgb_planar(y, uv)
    assert torch.equal(got, csc_cuda.nv12_to_rgb_planar_ref(y, uv))
    assert launch.LAUNCHES["csc_rgb_planar"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(4, 1080, 1920), (2, 270, 482),
                                   (1, 30, 100)])
def test_kernel_equals_plain_on_card(b, h, w):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    y, u, v, uv = (t.cuda() for t in _t(*_yuv(b, h, w, seed=h)))
    for space, rng in COMBOS:
        for swap in (False, True):
            kw = dict(space=space, rng=rng, swap=swap)
            before = launch.LAUNCHES["csc_rgb_planar"]
            got = csc_cuda.nv12_to_rgb_planar(y, uv, **kw)
            assert launch.LAUNCHES["csc_rgb_planar"] == before + 1
            assert torch.equal(got, csc_cuda.nv12_to_rgb_planar_ref(y, uv,
                                                                   **kw))
            got = csc_cuda.yuv420_to_rgb_planar(y, u, v, **kw)
            assert torch.equal(got, csc_cuda.yuv420_to_rgb_planar_ref(
                y, u, v, **kw))
    torch.cuda.synchronize()
