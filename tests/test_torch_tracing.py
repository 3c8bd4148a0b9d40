"""The port's trace spans: NVTX ranges for Nsight, ``record_function``
scopes while a ``torch.profiler`` profile runs, and the stage timers'
spans."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videoprocessingframework_torch.io import HostBatchRing
from videoprocessingframework_torch.models.resnet import resnet18_like
from videoprocessingframework_torch.models.vit import VideoViT, vit_tiny
from videoprocessingframework_torch.utils import tracing
from videoprocessingframework_torch.utils.tracing import (
    StageTimer,
    trace_range,
)


def _spans(prof, prefixes=("feed.", "model.", "outer", "inner", "x.")):
    """(name, start µs, end µs) of the profile's scopes named with one of
    ``prefixes``, in start order."""
    return sorted(
        ((e.name, e.time_range.start, e.time_range.end)
         for e in prof.events() if e.name.startswith(prefixes)),
        key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_reach_the_profiler_nested_under_their_names():
    timer = StageTimer("feed")
    with _cpu_profile() as prof:
        with trace_range("outer"):
            with timer.measure("dispatch"):
                with timer.measure("stage"):
                    torch.ones(4).sum()
            with trace_range("inner"):
                pass
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["outer", "feed.dispatch",
                                     "feed.stage", "inner"]
    outer, dispatch, stage, inner = spans
    assert _inside(dispatch, outer) and _inside(stage, dispatch)
    assert _inside(inner, outer) and not _inside(inner, dispatch)
    # the timer's stages keep their bare names
    assert set(timer.summary()) == {"dispatch", "stage"}
    assert timer.counts == {"dispatch": 1, "stage": 1}


class _Counting:
    """Stands in for ``torch.profiler.record_function`` and counts the
    scopes entered and left."""

    def __init__(self, real):
        self.real, self.entered, self.left = real, [], 0

    def __call__(self, name):
        counter = self

        class Scope:
            def __enter__(self):
                counter.entered.append(name)
                self.inner = counter.real(name)
                return self.inner.__enter__()

            def __exit__(self, *exc):
                counter.left += 1
                return self.inner.__exit__(*exc)

        return Scope()


def test_record_function_only_while_a_profiler_runs(monkeypatch):
    counting = _Counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timer = StageTimer("x")
    for _ in range(3):
        with trace_range("outer"), timer.measure("stage"):
            pass
    assert counting.entered == []
    assert timer.counts == {"stage": 3}
    with _cpu_profile():
        with trace_range("outer"), timer.measure("stage"):
            pass
    assert counting.entered == ["outer", "x.stage"]
    assert counting.left == 2
    with trace_range("outer"):
        pass
    assert counting.entered == ["outer", "x.stage"]


def test_nvtx_ranges_pushed_and_popped_when_cuda_is_up(monkeypatch):
    log = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: log.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: log.append(("pop",)))
    with pytest.raises(KeyError):
        with trace_range("DecodeFrame"), StageTimer("feed").measure("wait"):
            raise KeyError("boom")
    assert log == [("push", "DecodeFrame"), ("push", "feed.wait"),
                   ("pop",), ("pop",)]


@pytest.mark.parametrize("profiled", [False, True])
def test_exceptions_propagate_and_the_stage_is_still_timed(profiled):
    timer = StageTimer("feed")
    with _cpu_profile() if profiled else contextlib.nullcontext() as prof:
        with pytest.raises(ValueError, match="boom"):
            with trace_range("outer"), timer.measure("stage"):
                raise ValueError("boom")
        with timer.measure("stage"):
            pass
    assert timer.counts == {"stage": 2}
    if profiled:
        names = [s[0] for s in _spans(prof)]
        assert names == ["outer", "feed.stage", "feed.stage"]


def _ring_batches(ring, n):
    def post(y, u, v):
        return y.float().mean() + u.float().mean() + v.float().mean()

    return list(ring.rewind(n).batches(post, depth=2))


def test_cpu_ring_fills_its_stage_set():
    ring = HostBatchRing(32, 16, batch_size=2, n_batches=0, n_buffers=3,
                         seed=1, device="cpu")
    out = _ring_batches(ring, 5)
    assert len(out) == 5
    t = ring.timer
    # the CPU path copies the slot out of the ring (``stage``) and has
    # no staging buffer to wait for and no upload
    assert set(t.summary()) == {"acquire", "dispatch", "stage", "postproc",
                                "drain"}
    assert t.counts == {"acquire": 6, "dispatch": 5, "stage": 5,
                        "postproc": 5, "drain": 5}
    assert t.totals["stage"] + t.totals["postproc"] <= t.totals["dispatch"]


def test_ring_spans_nest_inside_each_dispatch():
    ring = HostBatchRing(32, 16, batch_size=2, n_batches=0, n_buffers=3,
                         seed=2, device="cpu")
    with _cpu_profile() as prof:
        _ring_batches(ring, 4)
    spans = _spans(prof)
    dispatches = [s for s in spans if s[0] == "feed.dispatch"]
    assert len(dispatches) == 4
    for name in ("feed.stage", "feed.postproc"):
        parts = [s for s in spans if s[0] == name]
        assert len(parts) == 4
        assert all(_inside(p, d) for p, d in zip(parts, dispatches))
    for d in dispatches:
        inner = [s for s in spans if s is not d and _inside(s, d)]
        assert sorted(s[0] for s in inner) == ["feed.postproc", "feed.stage"]
        assert sum(s[2] - s[1] for s in inner) <= d[2] - d[1]
    others = {s[0] for s in spans} - {"feed.dispatch", "feed.stage",
                                      "feed.postproc"}
    assert others == {"feed.acquire", "feed.drain"}


@pytest.mark.parametrize("build", [
    lambda: resnet18_like(num_classes=7, dtype=torch.float32),
    lambda: vit_tiny(num_classes=7, dtype=torch.float32,
                     image_size=(32, 32)),
], ids=["resnet", "vit"])
def test_model_forward_is_one_span_around_the_ops(build):
    model = build().eval()
    x = torch.rand(2, 32, 32, 3)
    with torch.no_grad(), _cpu_profile() as prof:
        model(x)
    spans = _spans(prof, ("model.",))
    assert [s[0] for s in spans] == ["model.forward"]
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    assert ops and all(_inside(
        ("op", e.time_range.start, e.time_range.end), spans[0])
        for e in ops)


def test_video_model_holds_its_vit_span():
    model = VideoViT(num_classes=5, dim=32, depth=1, heads=2,
                     temporal_depth=1, dtype=torch.float32, frames=2,
                     image_size=(32, 32)).eval()
    with torch.no_grad(), _cpu_profile() as prof:
        model(torch.rand(1, 2, 32, 32, 3))
    assert [s[0] for s in _spans(prof, ("model.",))] == ["model.forward"]


def test_span_check_is_the_profilers_own_flag():
    assert tracing._profiling() is False
    with _cpu_profile():
        assert tracing._profiling() is True
    assert tracing._profiling() is False


@pytest.mark.cuda
def test_cuda_ring_fills_its_stage_set():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ring = HostBatchRing(64, 32, batch_size=4, n_batches=0, n_buffers=4,
                         seed=3, device="cuda")
    with _cpu_profile() as prof:
        _ring_batches(ring, 6)
    t = ring.timer
    # each slot is page-locked once and copied from in place: no staging
    # buffer to wait for or fill
    assert set(t.summary()) == {"acquire", "dispatch", "register", "upload",
                                "postproc", "drain"}
    assert t.counts["register"] == 4
    assert all(t.counts[k] == 6 for k in ("dispatch", "upload", "postproc",
                                          "drain"))
    spans = _spans(prof)
    for d in (s for s in spans if s[0] == "feed.dispatch"):
        inner = [s for s in spans if s is not d and _inside(s, d)]
        assert sum(s[2] - s[1] for s in inner) <= d[2] - d[1]
