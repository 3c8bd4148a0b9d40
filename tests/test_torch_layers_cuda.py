"""The model layer's CUDA kernels (``models/layers_cuda.py``: LayerNorm
and MoonViT's RoPE of q and k) and the rule that picks them.

On the CPU: a CPU call takes the plain version and launches nothing; a
call that needs a gradient keeps the differentiable chain; the wrappers
refuse what the kernels do not take before touching a device; the one
launcher of ``csrc/launch.py``, over a stand-in for the kernel library,
passes the current stream last, counts each launch under its kernel's
name in ``LAUNCHES`` and in the ``counting`` contexts of its own thread
only, and raises a failed launch with the kernel's name and the error's
text; MoonViT reports its own launches; every C entry point of
``csrc/`` is bound with its parameter count; no kernel's name contains
a fragment by which the benchmark picks attention kernels.

On the card (``python -m pytest -m cuda tests/test_torch_layers_cuda.py``)
each kernel against its plain version at the shapes the cells run, and
LayerNorm at widths wider than a chunk of registers, not a multiple of 4,
on misaligned and strided views and in float16 and float64: bf16 and
float16 stores within one unit in the last place (ulp) of the plain
version's, float32 and float64 ones within 1e-5 of the largest value.
"""

import contextlib
import ctypes
import math
import pathlib
import re
import threading
import types

import pytest
import torch
import torch.nn.functional as F

from videoprocessingframework_torch.csrc import build, launch
from videoprocessingframework_torch.models import layers_cuda as lc
from videoprocessingframework_torch.models import moonvit as mv
from videoprocessingframework_torch.models.moonvit import (
    rope2d,
    rope_freqs,
    rope_qk,
)
from videoprocessingframework_torch.models.vit import LayerNorm

#: the name fragments of vpfbench's attention kernels
#: (``vpfbench/models/kimi_vl_moonvit.py`` ``ATTENTION_KERNELS``)
ATTENTION_FRAGMENTS = ("_sdpa_", "flash_fwd_kernel", "fmha_cutlassF")

#: float32 stores: largest |kernel − plain| over the plain version's
#: largest |value| (the same float32 sums in another order)
TOL_F32 = 1e-5


def _plain_ln(x, w, b, eps, out_dtype):
    """The plain version's chain (``LayerNorm.forward``)."""
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                        eps).to(out_dtype)


def _counts(**launched):
    """``LAUNCHES``'s shape: every kernel at 0 but ``launched``."""
    return {**dict.fromkeys(launch.LAUNCHES, 0), **launched}


def _norm(dim, out_dtype, eps, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    m = LayerNorm(dim, out_dtype, eps)
    with torch.no_grad():
        m.weight.copy_(1.0 + 0.1 * torch.randn(dim, generator=g))
        m.bias.copy_(0.1 * torch.randn(dim, generator=g))
    return m.to(device)


# ---- on the CPU -----------------------------------------------------------


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)], ids=["bf16-bf16", "bf16-f32", "f32-f32"])
def test_cpu_call_takes_the_plain_version(dtype, out_dtype):
    launch.reset_launches()
    m = _norm(384, out_dtype, 1e-6)
    x = torch.randn(2, 5, 384).to(dtype)
    with torch.no_grad():
        got = m(x)
    assert torch.equal(got, _plain_ln(x, m.weight, m.bias, 1e-6, out_dtype))
    assert got.dtype == out_dtype
    assert launch.LAUNCHES == _counts()


def test_gradient_equals_f_layer_norm():
    m = _norm(64, torch.float32, 1e-5, seed=2)
    x = torch.randn(3, 7, 64, requires_grad=True)
    gy = torch.randn(3, 7, 64)
    m(x).backward(gy)
    got = (x.grad.clone(), m.weight.grad.clone(), m.bias.grad.clone())
    x.grad = None
    w = m.weight.detach().clone().requires_grad_(True)
    b = m.bias.detach().clone().requires_grad_(True)
    F.layer_norm(x, (64,), w, b, 1e-5).backward(gy)
    for a, want in zip(got, (x.grad, w.grad, b.grad)):
        assert torch.equal(a, want)


@pytest.mark.parametrize("grad_mode,requires,want", [
    (True, (False, True, False), True),   # a parameter requires grad
    (True, (True, False, False), True),   # the input requires grad
    (True, (False, False, False), False),
    (False, (True, True, True), False),   # grad mode off
])
def test_needs_grad(grad_mode, requires, want):
    ts = [torch.zeros(2, requires_grad=r) for r in requires]
    with torch.set_grad_enabled(grad_mode):
        assert lc.needs_grad(*ts) is want


def test_takes_kernel_refuses_cpu_tensors():
    with torch.no_grad():
        assert not lc.takes_kernel(torch.zeros(4, 8))


def test_rope_qk_on_the_cpu_is_rope2d_of_q_and_k():
    launch.reset_launches()
    g = torch.Generator().manual_seed(4)
    rows, cols, heads, hd = 3, 5, 4, 16
    qkv = torch.randn(2, rows * cols, 3, heads, hd, generator=g).bfloat16()
    freqs = rope_freqs((rows, cols), hd, 10000.0)
    with torch.no_grad():
        q, k = rope_qk(qkv, freqs)
    assert torch.equal(q, rope2d(qkv[:, :, 0], freqs))
    assert torch.equal(k, rope2d(qkv[:, :, 1], freqs))
    assert launch.LAUNCHES["rope2d"] == 0


def _ln_args(**over):
    a = {"x": torch.zeros(4, 64, dtype=torch.bfloat16),
         "weight": torch.ones(64), "bias": torch.zeros(64), "eps": 1e-5,
         "out_dtype": torch.bfloat16}
    a.update(over)
    return a


@pytest.mark.parametrize("over,match", [
    ({"x": torch.zeros(4, 64, dtype=torch.int32)}, "float16 or float64"),
    ({"out_dtype": torch.int8}, "float16 or float64"),
    ({"x": torch.zeros(4, 64, dtype=torch.complex64)}, "float16 or float64"),
    ({"weight": torch.ones(32)}, r"must be \(64,\)"),
    ({"bias": torch.zeros(64, device="meta")}, r"must be \(64,\) on cpu"),
], ids=["int32-in", "int8-out", "complex-in", "weight-shape",
        "bias-elsewhere"])
def test_layer_norm_wrapper_refuses(over, match):
    with pytest.raises(ValueError, match=match):
        lc.layer_norm(**_ln_args(**over))


def _rope_args(**over):
    a = {"qkv": torch.zeros(2, 6, 3, 4, 16, dtype=torch.bfloat16),
         "freqs": rope_freqs((2, 3), 16, 10000.0)}
    a.update(over)
    return a


@pytest.mark.parametrize("over,match", [
    ({"qkv": torch.zeros(2, 6, 2, 4, 16, dtype=torch.bfloat16)},
     r"\(N, L, 3, heads, head_dim\)"),
    ({"qkv": torch.zeros(2, 6, 3, 4, 16, dtype=torch.int16)},
     "float16 or float64"),
    ({"qkv": torch.zeros(2, 6, 3, 4, 18, dtype=torch.bfloat16),
      "freqs": torch.zeros(6, 9, dtype=torch.complex64)}, "multiple of 4"),
    ({"freqs": rope_freqs((3, 3), 16, 10000.0)}, r"must be \(6, 8\)"),
    ({"freqs": rope_freqs((2, 3), 16, 10000.0).t().contiguous().t()},
     "contiguous"),
    ({"qkv": torch.zeros(2, 6, 3, 4, 18, dtype=torch.bfloat16)[..., 1:17]},
     "aligned"),
], ids=["not-qkv", "int16", "head-18", "table-shape", "table-strided",
        "misaligned"])
def test_rope2d_wrapper_refuses(over, match):
    with pytest.raises(ValueError, match=match):
        lc.rope2d(**_rope_args(**over))


class _Kernels:
    """Stands in for the kernel library: each ``vpf_<name>`` records its
    arguments and returns ``err``; the error's text is fixed."""

    def __init__(self):
        self.err = 0
        self.calls = []

    def vpf_cuda_error_string(self, err):
        return b"a stand-in error"

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((fn, args))
            return self.err
        return call


@pytest.fixture
def kernels(monkeypatch):
    """:func:`launch.launch` over :class:`_Kernels`, on a stand-in current
    stream whose handle is 77."""
    lib = _Kernels()
    monkeypatch.setattr(build, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=77))
    return lib


@pytest.mark.parametrize("a,b", [
    ("layer_norm", "rope2d"), ("fused_resize_csc", "csc_rgb_planar"),
    ("fused_resize_csc_direct", "layer_norm")],
    ids=["model-layer", "preprocess", "across-kinds"])
def test_counting_counts_its_own_context(kernels, a, b):
    """A launch calls ``vpf_<name>`` with the current stream last and
    counts under its name: in ``LAUNCHES`` and in each ``counting``
    context open in its thread (nested ones count into each); another
    thread's launches count only in ``LAUNCHES``."""
    cuda = torch.device("cuda")
    launch.reset_launches()
    with launch.counting() as outer:
        launch.launch(a, cuda, 1, 2.5)
        with launch.counting() as inner:
            launch.launch(b, cuda)
            other = threading.Thread(
                target=lambda: [launch.launch(a, cuda) for _ in range(5)])
            other.start()
            other.join(timeout=60)
            assert not other.is_alive()
        launch.launch(b, cuda)
    launch.launch(a, cuda)  # after both closed
    assert inner == _counts(**{b: 1})
    assert outer == _counts(**{a: 1, b: 2})
    assert launch.LAUNCHES == _counts(**{a: 7, b: 2})
    fn, args = kernels.calls[0]
    assert fn == f"vpf_{a}" and args[:-1] == (1, 2.5)
    assert isinstance(args[-1], ctypes.c_void_p) and args[-1].value == 77
    assert len(kernels.calls) == 9


@pytest.mark.parametrize("name", list(launch.LAUNCHES))
def test_failed_launch_raises_with_its_name(kernels, name):
    """A nonzero return raises with the kernel's name, the CUDA error and
    its text, and is not counted."""
    kernels.err = 700
    launch.reset_launches()
    with launch.counting() as counts:
        with pytest.raises(RuntimeError, match=(
                rf"^{name} launch failed: CUDA error 700 "
                r"\(a stand-in error\)$")):
            launch.launch(name, torch.device("cuda"))
    assert counts == _counts() and launch.LAUNCHES == _counts()


def test_moonvit_reports_its_own_launches(monkeypatch):
    """``vision_stats`` carries the launches of the model's own call, not
    those another thread makes meanwhile: the wrappers stand in for the
    kernels on the CPU, and the first norm lets another thread launch 5."""
    calls = {"n": 0}

    def norm(x, weight, bias, eps, out_dtype):
        calls["n"] += 1
        if calls["n"] == 1:
            other = threading.Thread(
                target=lambda: [launch._count("layer_norm")
                                for _ in range(5)])
            other.start()
            other.join()
        launch._count("layer_norm")
        return _plain_ln(x, weight, bias, eps, out_dtype)

    def rope(qkv, freqs):
        launch._count("rope2d")
        return rope2d(qkv[:, :, 0], freqs), rope2d(qkv[:, :, 1], freqs)

    monkeypatch.setattr(lc, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(lc, "layer_norm", norm)
    monkeypatch.setattr(lc, "rope2d", rope)
    torch.manual_seed(0)
    depth = 2
    m = mv.MoonViT(patch=2, dim=16, depth=depth, heads=2, mlp_dim=32,
                   pos_grid=(4, 4), out_dim=8, dtype=torch.float32).eval()
    launch.reset_launches()
    with torch.no_grad():
        m(torch.rand(1, 8, 8, 3))
    s = m.vision_stats
    assert (s["norm_launches"], s["rope_launches"]) == (2 * depth + 2, depth)
    assert launch.LAUNCHES == _counts(layer_norm=2 * depth + 2 + 5,
                                      rope2d=depth)


def _sources():
    return sorted(pathlib.Path(build.__file__).parent.glob("*.cu"))


def test_kernel_names_avoid_the_attention_fragments():
    """The benchmark picks attention kernels by name fragments; no kernel
    of the package may carry one."""
    names = []
    for src in _sources():
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                            r"\)\s+)?(\w+)", src.read_text())
    assert {"layer_norm_kernel", "rope2d_kernel"} <= set(names)
    for name in names:
        assert not any(f in name for f in ATTENTION_FRAGMENTS), name


def test_every_entry_point_is_bound_with_its_parameter_count(monkeypatch):
    """ctypes passes an unbound pointer as a 32-bit int: each C entry
    point gets a restype, and one argtype a parameter where its
    parameters are written out (the fused kernel's come from a macro)."""
    want = {}
    for src in _sources():
        for name, params in re.findall(
                r"VPF_KERNEL_API[^(]*?\b(vpf_\w+)\s*\(([^)]*)\)",
                src.read_text()):
            macro = re.search(r"\b[A-Z_]{4,}\b", params)
            want[name] = None if macro else len(
                [p for p in params.split(",") if p.strip()])
    assert want["vpf_layer_norm"] == 11 and want["vpf_rope2d"] == 14

    class Fn:
        restype = argtypes = None

    class Lib:
        def __init__(self, path):
            self.fns = {}

        def __getattr__(self, name):
            return self.__dict__["fns"].setdefault(name, Fn())

    monkeypatch.setattr(build, "build", lambda: pathlib.Path("unbuilt.so"))
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    lib = build.load_kernels.__wrapped__()
    for name, n in want.items():
        fn = lib.fns.get(name)
        assert fn is not None and fn.restype is not None, name
        if name != "vpf_cuda_error_string":
            assert fn.restype is ctypes.c_int, name
        assert n is None or len(fn.argtypes) == n, name


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


#: explicit mantissa bits of the 16-bit types
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """One ulp of ``v``'s 16-bit dtype at |v|, taken no finer than at
    2^-8: near zero the two versions' float32 sums, ~1e-7 of the terms
    apart, can round an output that cancels to nearly 0 more than its
    own ulp apart."""
    m = v.float().abs().clamp_min(2.0 ** -8)
    return torch.exp2(torch.floor(torch.log2(m)) - MANTISSA[v.dtype])


def _assert_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous()
    d = (got.float() - want.float()).abs()
    if want.dtype in MANTISSA:
        assert bool((d <= _ulp(want)).all()), float(d.max())
    else:
        assert float(d.max() / want.abs().max()) < TOL_F32


#: (rows' shape, width, input dtype, output dtype, ε): MoonViT's
#: residual stream, its projector's pre_norm, ViT-S/16's tokens, then
#: widths of one vector a lane, a half-masked pair, the widest row held
#: whole, rows of two and of several chunks (4096: VideoClassifier's
#: ``temporal_ln`` at width 128), widths not a multiple of 4 (scalar
#: loads, one chunk and several), and the float16 and float64 types
LN_CASES = {
    "moonvit-32768x1152": ((32768,), 1152, torch.bfloat16, torch.bfloat16,
                           1e-5),
    "pre_norm-8x1024x4x1152": ((8, 1024, 4), 1152, torch.bfloat16,
                               torch.bfloat16, 1e-5),
    "vit-32x197x384": ((32 * 197,), 384, torch.bfloat16, torch.float32,
                       1e-6),
    "f32-64": ((100,), 64, torch.float32, torch.float32, 1e-5),
    "f32-192": ((100,), 192, torch.float32, torch.bfloat16, 1e-6),
    "bf16-2048": ((100,), 2048, torch.bfloat16, torch.float32, 1e-6),
    "bf16-4096": ((4, 64), 4096, torch.bfloat16, torch.bfloat16, 1e-6),
    "f32-10000": ((50,), 10000, torch.float32, torch.float32, 1e-5),
    "bf16-1150": ((100,), 1150, torch.bfloat16, torch.bfloat16, 1e-5),
    "f32-4098": ((50,), 4098, torch.float32, torch.bfloat16, 1e-6),
    "f16-4096": ((64,), 4096, torch.float16, torch.float16, 1e-5),
    "f16-1152-f32": ((300,), 1152, torch.float16, torch.float32, 1e-5),
    "f64-384": ((100,), 384, torch.float64, torch.float64, 1e-6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LN_CASES))
def test_layer_norm_kernel_against_plain(cuda, case):
    lead, d, dt, out_dt, eps = LN_CASES[case]
    m = _norm(d, out_dt, eps, seed=5, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    # an offset and a scale a row, as a residual stream has
    x = (3.0 * torch.randn(*lead, d, device=cuda, generator=g)
         + torch.randn(*lead, 1, device=cuda, generator=g)).to(dt)
    launch.reset_launches()
    with torch.no_grad():
        got = m(x)
    assert launch.LAUNCHES["layer_norm"] == 1
    _assert_close(got, _plain_ln(x, m.weight, m.bias, eps, out_dt))


@pytest.mark.cuda
def test_layer_norm_kernel_on_class_token_rows(cuda):
    """ViT's final norm of ``x[:, 0]``: rows 197·384 elements apart."""
    m = _norm(384, torch.float32, 1e-6, seed=7, device=cuda)
    x = torch.randn(32, 197, 384, device=cuda).bfloat16()
    rows = x[:, 0]
    assert not rows.is_contiguous()
    launch.reset_launches()
    with torch.no_grad():
        got = m(rows)
    assert launch.LAUNCHES["layer_norm"] == 1
    _assert_close(got, _plain_ln(rows, m.weight, m.bias, 1e-6,
                                 torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["misaligned", "strided-last-dim"])
def test_layer_norm_kernel_on_any_view(cuda, view):
    """Rows that start one element off a vector (scalar loads) and rows
    whose last dimension is strided (copied contiguous first)."""
    m = _norm(384, torch.bfloat16, 1e-5, seed=10, device=cuda)
    base = torch.randn(64, 386, device=cuda).bfloat16()
    x = base[:, 1:385] if view == "misaligned" else \
        base[:, :384].t().contiguous().t()
    assert not x.is_contiguous()
    launch.reset_launches()
    with torch.no_grad():
        got = m(x)
    assert launch.LAUNCHES["layer_norm"] == 1
    _assert_close(got, _plain_ln(x, m.weight, m.bias, 1e-5, torch.bfloat16))


@pytest.mark.cuda
def test_grad_call_keeps_the_plain_chain_on_the_card(cuda):
    m = _norm(384, torch.float32, 1e-6, seed=8, device=cuda)
    x = torch.randn(16, 384, device=cuda).bfloat16()
    launch.reset_launches()
    y = m(x)
    assert launch.LAUNCHES["layer_norm"] == 0 and y.requires_grad
    y.sum().backward()
    w = m.weight.detach().clone().requires_grad_(True)
    b = m.bias.detach().clone().requires_grad_(True)
    F.layer_norm(x.float(), (384,), w, b, 1e-6).sum().backward()
    assert torch.equal(m.weight.grad, w.grad)
    assert torch.equal(m.bias.grad, b.grad)


#: (batch, grid, heads, head_dim, dtype): MoonViT at 896² (64×64) and on
#: a 6×10 grid, and the tiny float32 model's heads
ROPE_CASES = {
    "moonvit-8x64x64": (8, (64, 64), 16, 72, torch.bfloat16),
    "moonvit-8x6x10": (8, (6, 10), 16, 72, torch.bfloat16),
    "f32-2x6x10-h16": (2, (6, 10), 4, 16, torch.float32),
    "bf16-2x6x10-h12": (2, (6, 10), 4, 12, torch.bfloat16),
    "f16-8x6x10": (8, (6, 10), 16, 72, torch.float16),
    "f64-2x6x10-h16": (2, (6, 10), 4, 16, torch.float64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_rope_kernel_against_plain(cuda, case):
    n, grid, heads, hd, dt = ROPE_CASES[case]
    length = math.prod(grid)
    g = torch.Generator(device=cuda).manual_seed(9)
    # the QKV projection's output as the block views it
    qkv = torch.randn(n, length, 3 * heads * hd, device=cuda,
                      generator=g).to(dt).view(n, length, 3, heads, hd)
    freqs = rope_freqs(grid, hd, 10000.0, cuda)
    launch.reset_launches()
    with torch.no_grad():
        q, k = rope_qk(qkv, freqs)
    assert launch.LAUNCHES["rope2d"] == 1
    for i, got in enumerate((q, k)):
        _assert_close(got, rope2d(qkv[:, :, i], freqs))
        # the attention's input view keeps the plain version's strides
        assert got.transpose(1, 2).stride() == \
            rope2d(qkv[:, :, i], freqs).transpose(1, 2).stride()
