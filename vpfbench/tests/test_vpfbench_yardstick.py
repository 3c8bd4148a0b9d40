"""The yardstick's counts: FLOPs a frame from the architectures' shapes
and the pre-processing's least work."""

import pytest

from vpfbench import harness, yardstick


@pytest.mark.parametrize("name, published", [("resnet50", 4.1e9),
                                             ("vit_s16", 4.6e9)])
def test_flops_near_published_multiply_adds(name, published):
    cell = next(harness.load_cell(w["name"]) for w in
                harness.read_json(harness.ROOT / "BENCHMARK.json")
                ["workloads"] if w["config"] == name)
    macs = cell.model.flops_per_frame(cell.config) / 2
    assert abs(macs / published - 1) < 0.03


def test_preprocess_work_at_1080p():
    nbytes, flops = yardstick.preprocess_work(32, 1080, 1920, 224, 224)
    assert nbytes == 118_800_384
    rates = yardstick.peaks("NVIDIA H100 80GB HBM3")
    least = yardstick.preprocess_least_s(32, 1080, 1920, 224, 224, rates)
    assert least == pytest.approx(118_800_384 / 3.35e12)
    assert least == pytest.approx(0.0355e-3, rel=0.01)
    assert flops / rates["fp32"] < least  # bound by bytes


def test_peaks_by_name():
    assert yardstick.peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert yardstick.peaks("NVIDIA H100 PCIe")["memory"] == 2.0e12
    with pytest.raises(ValueError):
        yardstick.peaks("NVIDIA A100-SXM4-80GB")
