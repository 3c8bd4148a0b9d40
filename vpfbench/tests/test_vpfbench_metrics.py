"""The per-layer readers on records made by hand."""

import pytest

from vpfbench import harness
from vpfbench.yardstick import peaks, preprocess_work

READERS = harness.HERE / "metrics"


def _reader(name):
    return harness.load_module(READERS / f"{name}.py", "metrics")


def _record():
    rec = harness.Record()
    rec.params = {"height": 1080, "width": 1920, "out_size": 224,
                  "batch": 32}
    rec.flops_per_frame = 8e9
    rec.rates = peaks("NVIDIA H100 80GB HBM3")
    return rec


def test_host_readers_leave_out_the_profiled_batches():
    rec = _record()
    rec.t_window0 = 10.0
    t, ends = 10.0, []
    for i in range(300):
        # 10 ms a batch, 40 ms while the profiler is on
        t += 0.04 if 100 <= i < 140 else 0.01
        ends.append((t, 32, 0.005, 0.003 if 100 <= i < 140 else 0.002))
    rec.batches = ends
    rec.profiled = [(ends[99][0] + 0.001, ends[139][0] - 0.001)]
    per_frame = 8e9 + preprocess_work(1, 1080, 1920, 224, 224)[1]
    want = 100 * per_frame * 3200 / 989e12
    assert _reader("step_mfu.offline").read(rec) == pytest.approx(want)
    dispatch = _reader("feed.dispatch_ms.offline")
    assert dispatch.read(rec) == pytest.approx(2.0)
    assert _reader("model.enqueue_ms.offline").read(rec) == \
        pytest.approx(5.0)
    assert _reader("pipeline.frames_per_s.offline_mem").read(rec) == \
        pytest.approx(3200.0)
    rec.profiled = []
    assert _reader("step_mfu.offline").read(rec) < 0.8 * want
    assert dispatch.read(rec) > 2.1


@pytest.mark.parametrize("name", sorted(
    p.name[:-len(".offline_mem.py")]
    for p in READERS.glob("*.offline_mem.py")
    if (READERS / p.name.replace(".offline_mem.", ".offline.")).exists()))
def test_memory_gated_readers_read_as_their_twins(name):
    """A ``.offline_mem`` reader gives its ``.offline`` twin's reading."""
    rec = _record()
    rec.t_window0 = 0.0
    rec.batches = [(0.01 * (i + 1), 32, 0.005, 0.002) for i in range(50)]
    twin = _reader(f"{name}.offline").read(rec)
    assert _reader(f"{name}.offline_mem").read(rec) == twin


def test_readers_find_nothing_in_an_empty_record():
    for path in READERS.glob("*.*.py"):
        reader = harness.load_module(path, "metrics")
        assert reader.read(_record()) is None, path.name
