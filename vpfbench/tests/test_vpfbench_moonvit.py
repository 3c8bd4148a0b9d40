"""The MoonViT cell's own pieces: its FLOP counts, its reference against
the port at a tiny width on an interpolated non-square grid, the
attention roofline's reader on a Summary made by hand, and on the card
(``python -m pytest -m cuda vpfbench/tests``) that the reader's name
fragments pick exactly the kernels launched inside ``model.attention``."""

import copy

import pytest
import torch

from vpfbench import harness
from vpfbench.models import kimi_vl_moonvit as mod
from vpfbench.reference import kimi_vl_moonvit as ref
from vpfbench.tracing import Summary, _is_copy

CFG = harness.read_json(harness.HERE / "configs" / "kimi_vl_moonvit.json")
READER = harness.load_module(
    harness.HERE / "metrics" / "model.attention_roofline.moonvit.py",
    "metrics")


def _tiny(image_size=112):
    """The configuration at width 64, 4 heads of 16, MLP 172, 2 blocks,
    an 8×8 table and a projector to 32, in float32."""
    cfg = copy.deepcopy(CFG)
    cfg["vision_config"].update(
        hidden_size=64, num_attention_heads=4, intermediate_size=172,
        num_hidden_layers=2, init_pos_emb_height=8, init_pos_emb_width=8)
    return dict(cfg, hidden_size=32, image_size=image_size, dtype="float32")


def test_flops_at_896():
    assert mod.flops_per_frame(CFG) == pytest.approx(5.52e12, rel=2e-3)
    assert mod.attention_flops_per_frame(CFG) == pytest.approx(2.087e12,
                                                               rel=1e-3)
    # 447.5M parameters at the published widths
    n = sum(torch.Size(shape).numel() for _, shape, _ in mod._leaves(CFG))
    assert 447e6 < n < 448e6


@pytest.mark.parametrize("rows, cols", [(8, 8), (6, 10)])
def test_reference_matches_the_port_in_float32(rows, cols):
    cfg = _tiny()
    w = mod.weights(cfg, 2 ** 31 + 77, "cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 14 * rows, 14 * cols, 3, generator=g)
    with torch.no_grad():
        fn = mod.build(cfg, w)
        got = fn(x)
        want = ref.forward(w, x, cfg)
    assert got.shape == want.shape == (3, rows * cols // 4 * 32)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    stats = fn.model.vision_stats
    assert stats["pos_interpolations"] == int((rows, cols) != (8, 8))


def _summary(ops, model_calls, pre_calls):
    s = Summary([])
    s.ops.update(ops)
    s.ranges["vpfbench.model"] = list(model_calls)
    s.ranges["vpfbench.preprocess"] = list(pre_calls)
    return s


def _record(trace):
    rec = harness.Record()
    rec.params = {"batch": 8, "out_size": 896, "height": 1080,
                  "width": 1920}
    rec.rates = {"bf16": 989e12}
    rec.trace = trace
    return rec


def test_attention_roofline_on_a_made_summary():
    """Device stretches of 5 calls' kernels: 0.1 s a call of the model
    (0.045 s of it cuDNN's attention kernel) and 0.001 s of
    pre-processing, besides copies that count for nothing."""
    calls = 5
    ops = {"cudnn_generated_fort_native_sdpa_sm90_flash_fprop_kernel0_0":
           0.045 * calls,
           "nvjet_tst_128x144_64x6_1x2_h_bz_coopA_bias_TNT": 0.055 * calls,
           "fused_resize_csc": 0.001 * calls,
           "Memcpy HtoD (Pinned -> Device)": 0.3,
           "Memset (Device)": 0.01}
    rec = _record(_summary(ops, [0.1, 0.1], [0.001, 0.001]))
    frames = 8 * calls
    want = 100 * 2.087354105856e12 * frames / (0.045 * calls * 989e12)
    assert READER.read(rec) == pytest.approx(want)
    # the share is read from the frames the stretches ran, whatever the
    # host stretches' count of calls
    rec2 = _record(_summary(ops, [0.1] * 7, [0.001] * 7))
    assert READER.read(rec2) == pytest.approx(want)


def test_attention_roofline_finds_nothing_without_its_kernels():
    ops = {"nvjet_tst_128x144": 1.0}
    assert READER.read(_record(_summary(ops, [0.1], [0.001]))) is None
    ops = {"pytorch_flash::flash_fwd_kernel<x>": 1.0}
    assert READER.read(_record(_summary(ops, [], []))) is None
    assert READER.read(_record(None)) is None


@pytest.mark.cuda
def test_fragments_select_the_kernels_inside_attention_spans():
    """One eager forward of the published model under the profiler: the
    kernels launched inside ``model.attention`` spans (matched by
    correlation id) are exactly those the fragments pick, 27 of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    w = mod.weights(CFG, 2 ** 31 + 11, dev)
    fn = mod.build(CFG, w)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, 896, 896, 3, device=dev, generator=g)
    with torch.no_grad():
        fn.model._forward(x)  # picks the backend
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn.model._forward(x)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(),
              e.start_thread_id()) for e in events
             if e.device_type() == cpu and e.name() == "model.attention"]
    launches = {e.correlation_id(): (e.start_ns(), e.start_thread_id())
                for e in events
                if e.device_type() == cpu and e.name().startswith("cu")}
    inside, picked = [], []
    for e in events:
        if e.device_type() == cpu or e.is_user_annotation() \
                or _is_copy(e.name()):
            continue
        t, thread = launches.get(e.correlation_id(), (None, None))
        if t is not None and any(a <= t <= b and thread == th
                                 for a, b, th in spans):
            inside.append(e.name())
        if any(f in e.name() for f in mod.ATTENTION_KERNELS):
            picked.append(e.name())
    assert len(spans) == 27
    assert sorted(inside) == sorted(picked) and len(picked) == 27
