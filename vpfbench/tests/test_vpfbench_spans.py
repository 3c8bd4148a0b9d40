"""``spans.SpanSummary`` on profiler events made by hand: the gap paths
and the launches of each ``model.forward``, and every reading of
``tracing.Summary`` the same with and without the port's spans."""

import pytest
import torch

from vpfbench import spans as S
from vpfbench.tests import small
from vpfbench.tracing import Summary

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    """The part of a ``_KinetoEvent`` the summaries read."""

    def __init__(self, name, start, end, corr=0, thread=1, device=CPU,
                 annotation=False):
        self._v = (name, start, end - start, corr, thread, device,
                   annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def device_type(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def span(name, start, end, thread=1):
    return Ev(name, start, end, thread=thread, annotation=True)


def kernel(name, start, end, corr):
    return Ev(name, start, end, corr=corr, thread=0, device=CUDA)


def host_events(program_spans=True):
    """One feed call and one model call on thread 1 (ns): a copy, five
    kernels of which two come from one CUDA graph launch, a wait on an
    event that launches nothing, and the device's mirror of each span."""
    ev = [
        kernel("earlier_kernel", 0, 2, 100),
        Ev("vpfbench.feed", 0, 100, annotation=True),
        Ev("aten::copy_", 12, 58),
        Ev("cudaMemcpyAsync", 62, 64, corr=101),
        kernel("Memcpy HtoD (Pinned -> Device)", 80, 120, 101),
        Ev("vpfbench.model", 100, 300, annotation=True),
        Ev("aten::to", 105, 120),
        Ev("cudaLaunchKernel", 110, 112, corr=201),
        kernel("cast_kernel", 130, 140, 201),
        Ev("aten::conv", 150, 200),
        Ev("aten::cudnn_convolution", 151, 199),
        Ev("cudaLaunchKernel", 160, 162, corr=202),
        kernel("conv_kernel", 170, 175, 202),
        Ev("cudaGraphLaunch", 210, 212, corr=203),
        kernel("graph_kernel_a", 215, 220, 203),
        kernel("graph_kernel_b", 222, 226, 203),
        Ev("cudaStreamWaitEvent", 230, 231, corr=204),
        Ev("cudaLaunchKernel", 285, 286, corr=205),
        kernel("head_kernel", 290, 292, 205),
        Ev("vpfbench.model", 130, 292, thread=0, device=CUDA,
           annotation=True),
    ]
    if program_spans:
        ev += [
            span("feed.dispatch", 5, 95),
            span("feed.stage", 10, 60),
            span("feed.upload", 60, 70),
            span("model.forward", 102, 298),
            Ev("model.forward", 130, 292, thread=0, device=CUDA,
               annotation=True),
        ]
    return ev


def device_events():
    return [kernel("k", 1000, 1010, 1), kernel("Memset", 1020, 1030, 2),
            kernel("k", 1050, 1060, 3),
            Ev("model.forward", 1000, 1060, thread=0, device=CUDA,
               annotation=True)]


def stretches(program_spans=True):
    return [(False, (995, 1100), device_events()),
            (True, (0, 300), host_events(program_spans))]


def readings(s: Summary) -> dict:
    return {"window_s": s.window_s, "busy_s": s.busy_s,
            "kernel_s": s.kernel_s, "copy_s": s.copy_s,
            "clipped_s": s.clipped_s, "ops": dict(s.ops),
            "ranges": dict(s.ranges), "gaps": dict(s.gaps),
            "model": s.device_s("model"), "feed": s.device_s("feed"),
            "breakdown": s.breakdown()}


def test_every_summary_reading_is_the_same_with_program_spans():
    plain = readings(Summary(stretches(program_spans=False)))
    assert readings(Summary(stretches())) == plain
    assert readings(S.SpanSummary(stretches())) == plain
    # the spans' device mirrors add no busy time and no operation
    assert plain["busy_s"] == pytest.approx(30e-9)
    assert "model.forward" not in plain["ops"]
    assert plain["model"] == [pytest.approx(
        (10 + 5 + 5 + 4 + 2) * 1e-9)]


def test_gaps_are_named_by_range_span_and_op():
    s = S.SpanSummary(stretches())
    want = {
        ("vpfbench.feed", "feed.upload", "python"): 128,
        ("vpfbench.model", "model.forward", "aten::conv"): 30 + 40,
        ("vpfbench.model", "model.forward", "python"): 2 + 64,
    }
    assert {k: round(v * 1e9) for k, v in s.paths.items()} == want
    # the first label is the one Summary gives
    first = {}
    for path, sec in s.paths.items():
        first[path[0]] = first.get(path[0], 0.0) + sec
    assert first == pytest.approx(dict(s.gaps))
    assert s.span_share() == 1.0


def test_gaps_without_program_spans_name_range_and_op():
    s = S.SpanSummary(stretches(program_spans=False))
    assert {k: round(v * 1e9) for k, v in s.paths.items()} == {
        ("vpfbench.feed", "python"): 128,
        ("vpfbench.model", "aten::conv"): 70,
        ("vpfbench.model", "python"): 66,
    }
    assert s.span_share() == 0.0
    assert s.launches == []


def test_launches_count_calls_that_reach_the_device():
    s = S.SpanSummary(stretches())
    # 201, 202, the graph launch 203 once and 205; the event wait 204
    # reaches no device
    assert s.launches == [4]


def test_launches_read_the_outermost_forward_of_each_call():
    ev = host_events() + [
        span("model.forward", 140, 180),  # a model run inside another
        Ev("vpfbench.model", 400, 500, annotation=True),
        span("model.forward", 401, 499),
        Ev("cudaLaunchKernel", 410, 411, corr=301),
        kernel("k", 420, 421, 301),
    ]
    s = S.SpanSummary([(True, (0, 600), ev)])
    assert s.launches == [4, 1]


def test_roots_are_the_ops_no_other_op_holds():
    ops = [(1, 9, "a"), (2, 3, "b"), (10, 12, "c"), (10, 11, "d")]
    assert S._roots(ops) == [(1, 9, "a"), (10, 12, "c")]


def test_profile_cell_reads_the_stages_on_the_cpu():
    ctx = small.context("vit_s16.offline", seconds=0.4, trace=True)
    out = S.profile_cell(ctx, stretches=2, length=0.02, paired_length=0.02)
    assert out["batches"] >= 1
    assert {"acquire", "dispatch", "stage", "postproc", "drain",
            "model.enqueue"} <= set(out["stage_ms"])
    ms = out["stage_ms"]
    assert ms["stage"] + ms["postproc"] <= ms["dispatch"]
    assert out["parts_within_dispatch"]
    for kind in ("spans_on", "spans_off"):
        assert out["paired_batches"][kind]["batches"] >= 1
    # no device: no kernels, so no gaps, and no call reaches a device
    assert out["idle_gaps"] == [] and out["launches"]["max"] == 0
