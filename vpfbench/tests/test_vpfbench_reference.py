"""The reference agrees with the port's torch path at a small size on
the CPU, and it imports nothing of the port."""

import ast

import numpy as np
import pytest
import torch

from vpfbench import frames, harness
from vpfbench.models import resnet50 as resnet_mod
from vpfbench.models import vit_s16 as vit_mod
from vpfbench.reference import preprocess as ref_pre
from vpfbench.reference import resnet50 as ref_resnet
from vpfbench.reference import vit_s16 as ref_vit


def test_preprocess_matches_the_ports_torch_path():
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.ops.fused import FusedPipeline

    y, u, v = frames.yuv420(3, 64, 96, 99, "cpu")
    pipe = FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                         ColorRange.MPEG, (40, 24), output="normalized",
                         device="cpu", kernel="torch")
    got = pipe(y, u, v)
    want = ref_pre.preprocess(y, u, v, 24, 40, "bt709", "mpeg")
    assert got.shape == want.shape == (3, 24, 40, 3)
    assert float((got - want).abs().max()) < 1e-4


def test_ring_slots_round_trip():
    y, u, v = frames.yuv420(2, 64, 96, 5, "cpu")
    slot = frames.ring_slots(y, u, v, 2)[0]
    for a, b in zip(frames.slot_planes(slot, 2, 64, 96), (y, u, v)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("mod, ref, name", [
    (resnet_mod, ref_resnet, "resnet50"), (vit_mod, ref_vit, "vit_s16")])
def test_model_matches_the_port_in_float32(mod, ref, name):
    cfg = harness.read_json(harness.HERE / "configs" / f"{name}.json")
    cfg = dict(cfg, image_size=32, dtype="float32")
    w = mod.weights(cfg, 2 ** 31 + 5, "cpu")
    x = ref_pre.preprocess(*frames.yuv420(4, 64, 96, 7, "cpu"), 32, 32)
    with torch.no_grad():
        got = mod.build(cfg, w)(x)
        want = ref.forward(w, x, cfg)
    assert got.shape == (4, cfg["num_classes"])
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < 1e-4 * scale


def test_weights_repeat_for_a_seed():
    cfg = harness.read_json(harness.HERE / "configs" / "vit_s16.json")
    a = vit_mod.weights(cfg, 2 ** 31 + 9, "cpu")
    b = vit_mod.weights(cfg, 2 ** 31 + 9, "cpu")
    c = vit_mod.weights(cfg, 2 ** 31 + 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pos_embed"], c["pos_embed"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    banned = {"videoprocessingframework_torch"} | set(harness.FORBIDDEN)
    for path in sorted((harness.HERE / "reference").glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & banned, (path.name, tops & banned)
