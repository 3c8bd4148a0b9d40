"""The port's MoonViT (``models/moonvit.py``) against the plain float32
reference (``tests/_reference_moonvit.py``) on seeded random weights, at
a tiny size on the CPU: width 64, 4 heads of 16, MLP 172, 2 blocks, an
8×8 position table, a 2×2 merge and a projector to 32. Then its parts
(RoPE2D, the merge's order, the input check), its counters, and on the
card the published model's graph replay and attention backend.

Card tests skip without one: ``python -m pytest -m cuda
tests/test_torch_moonvit.py``.
"""

import pytest
import torch

from videoprocessingframework_torch import models as tm
from videoprocessingframework_torch.models.graphed import EAGER_RUNS
from videoprocessingframework_torch.models.moonvit import (
    MoonViT,
    merge_patches,
    rope2d,
    rope_freqs,
)

import _reference_moonvit as ref

TINY = {"patch": 14, "dim": 64, "depth": 2, "heads": 4, "mlp_dim": 172,
        "pos_grid": (8, 8), "merge": (2, 2), "out_dim": 32, "eps": 1e-5,
        "rope_theta": 10000.0}

#: largest |port − reference| over the reference's largest |value|, in
#: float32: the same sums in another order (SDPA's fused softmax, complex
#: RoPE, the convolution), rounding near 1e-7 of each operand; measured
#: 4e-7 to 6e-7 on three seeds
TOL_F32 = 1e-5
#: the same in bf16 compute: each product's operands and the residual
#: stream rounded to 8 significant bits (2^-9 ≈ 2e-3 relative) through 2
#: blocks and the projector; measured 0.0066 to 0.0098 on three seeds
TOL_BF16 = 0.03


def _weights(model, seed):
    """Every parameter drawn from ``seed``: products at unit gain, so no
    block's branch vanishes beside the residual."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.state_dict().items():
        z = torch.randn(p.shape, generator=g)
        if name.endswith("norm0.weight") or name.endswith("norm1.weight") \
                or name.endswith("layernorm.weight") \
                or name.endswith("pre_norm.weight"):
            out[name] = 1.0 + 0.1 * z
        elif name == "pos_emb":
            out[name] = 0.5 * z
        elif name.endswith(".weight"):
            out[name] = z / (p[0].numel() ** 0.5)
        else:
            out[name] = 0.05 * z
    return out


def _model(dtype=torch.float32, seed=7):
    model = MoonViT(**TINY, dtype=dtype).eval()
    w = _weights(model, seed)
    model.load_state_dict(w)
    return model, w


def _frames(n, rows, cols, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 14 * rows, 14 * cols, 3, generator=g)


@pytest.mark.parametrize("grid", [(8, 8), (6, 10)], ids=["8x8", "6x10"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_matches_the_plain_reference(grid, dtype):
    """The table as it is (8×8) and bicubically interpolated to a
    non-square grid (6×10); bf16 compute holds to its own tolerance and
    fails the float32 one."""
    model, w = _model(dtype)
    x = _frames(2, *grid)
    with torch.no_grad():
        got = model(x)
        want = ref.forward(w, x, TINY)
    tokens = grid[0] * grid[1] // 4
    assert got.shape == want.shape == (2, tokens, 32)
    assert got.dtype == torch.float32
    err = float((got - want).abs().max() / want.abs().max())
    if dtype == torch.float32:
        assert err < TOL_F32
    else:
        assert TOL_F32 < err < TOL_BF16


def test_rope2d_against_cos_sin():
    g = torch.Generator().manual_seed(1)
    rows, cols, d = 3, 5, 16
    t = torch.randn(2, rows * cols, 4, d, generator=g)
    got = rope2d(t, rope_freqs((rows, cols), d, 10000.0))
    want = ref.rope(t.transpose(1, 2), rows, cols, 10000.0).transpose(1, 2)
    assert got.dtype == t.dtype
    assert torch.allclose(got, want, rtol=0, atol=1e-5)
    # position 0 is not turned; pair (4i+2, 4i+3) turns with the row only
    assert torch.equal(got[:, 0], t[:, 0])
    one_col = rope2d(t[:, :rows], rope_freqs((rows, 1), d, 10000.0))
    assert torch.allclose(one_col[:, 1, :, 0:2], t[:, 1, :, 0:2], atol=1e-6)
    assert not torch.allclose(one_col[:, 1, :, 2:4], t[:, 1, :, 2:4])
    # bf16 in, bf16 out, turned in float32
    half = rope2d(t.bfloat16(), rope_freqs((rows, cols), d, 10000.0))
    assert half.dtype == torch.bfloat16


def test_merge_order_is_row_col():
    rows, cols = 4, 6
    pos = torch.arange(rows * cols)
    t = torch.stack([pos // cols, pos % cols], -1)[None].float()  # (1, L, 2)
    out = merge_patches(t, (rows, cols), (2, 2))
    assert out.shape == (1, rows * cols // 4, 4, 2)
    for r in range(rows // 2):
        for c in range(cols // 2):
            parts = out[0, r * (cols // 2) + c].tolist()
            assert parts == [[2 * r, 2 * c], [2 * r, 2 * c + 1],
                             [2 * r + 1, 2 * c], [2 * r + 1, 2 * c + 1]]


def test_vision_stats_count_grids_and_interpolations():
    model, _ = _model()
    with torch.no_grad():
        model(_frames(1, 8, 8))
        assert model.vision_stats == {"patches": 64, "tokens": 16,
                                      "pos_interpolations": 0,
                                      "attention_backend": None,
                                      "norm_launches": 0,
                                      "rope_launches": 0}
        model(_frames(1, 6, 10))
        model(_frames(1, 6, 10))
    assert model.vision_stats == {"patches": 60, "tokens": 15,
                                  "pos_interpolations": 2,
                                  "attention_backend": None,
                                  "norm_launches": 0, "rope_launches": 0}


def test_input_check():
    model, _ = _model()
    with pytest.raises(ValueError, match="multiples of 28"):
        model(torch.zeros(1, 14 * 3, 14 * 8, 3))
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        model(torch.zeros(1, 112, 112, 4))
    assert model.vision_stats["patches"] == 0


def test_eager_reasons_on_the_cpu():
    model, _ = _model()
    x = _frames(1, 8, 8)
    with torch.no_grad():
        model(x)
        model(x)
    model(x)  # gradients on
    model.train()
    with torch.no_grad():
        model(x)
    s = model.graph_stats
    assert s["captures"] == s["replays"] == 0
    assert s["eager"] == {"cpu": 2, "grad": 1, "training": 1}


def test_published_widths():
    with torch.device("meta"):
        m = tm.kimi_vl_moonvit()
    assert len(m.blocks) == 27 and m.dim == 1152 and m.heads == 16
    assert m.blocks[0].fc0.out_features == 4304
    assert tuple(m.pos_emb.shape) == (64, 64, 1152)
    assert m.linear_1.in_features == m.linear_1.out_features == 4608
    assert m.linear_2.out_features == 2048
    assert m.final_layernorm.eps == 1e-5
    n = sum(p.numel() for p in m.parameters())
    assert 446e6 < n < 448e6


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replay_equals_eager_at_896(cuda):
    """The published model at the benchmark's batch of 8 and 896²: the
    replays equal the eager forward, on a fused attention backend; the
    capture launched the LayerNorm kernel 56 times (2 a block, the final
    norm, the projector's) and the RoPE kernel 27 times."""
    torch.manual_seed(0)
    m = tm.kimi_vl_moonvit().to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    xs = [torch.randn(8, 896, 896, 3, device=cuda, generator=g)
          for _ in range(3)]
    with torch.no_grad():
        for x in xs[:EAGER_RUNS]:
            m(x)
        replayed = [m(x) for x in xs]
        counted = (m.vision_stats["norm_launches"],
                   m.vision_stats["rope_launches"])
        want = [m._forward(x) for x in xs]
    s = m.graph_stats
    assert s["captures"] == 1 and s["replays"] == 3
    assert s["eager"] == {"warmup": EAGER_RUNS}
    assert counted == (56, 27)
    for got, w in zip(replayed, want):
        assert got.shape == (8, 1024, 2048) and got.dtype == torch.float32
        assert torch.equal(got, w)
    assert m.vision_stats["patches"] == 4096
    assert m.vision_stats["tokens"] == 1024
    assert m.vision_stats["pos_interpolations"] == 0
    backend = m.vision_stats["attention_backend"]
    assert backend in ("flash_attention", "cudnn_attention",
                       "efficient_attention")


@pytest.mark.cuda
def test_interpolated_grid_matches_the_reference_on_the_card(cuda):
    """The tiny model in float32 on CUDA (a fused backend, not math) at a
    non-square grid, against the reference with TF32 off."""
    model, w = _model(torch.float32)
    model = model.to(cuda)
    x = _frames(2, 6, 10).to(cuda)
    with torch.no_grad(), ref.strict_float32():
        got = model(x)
        want = ref.forward({k: v.to(cuda) for k, v in w.items()}, x, TINY)
    assert model.vision_stats["attention_backend"] != "math"
    err = float((got - want).abs().max() / want.abs().max())
    assert err < TOL_F32
