"""The models' CUDA-graph replay (``models/graphed.py``) on the card:
replays against the eager forward at the benchmark's batch of 32 and at a
server bucket, outputs that a later replay leaves alone, a replaced
parameter storage or a swapped submodule captured again, an in-place
update read by the replay,
calls from another stream, the spans, and the eager runs of a thread that finds the
lock held or of a forward that cannot be captured.

Skipped without a card: ``python -m pytest -m cuda tests/test_torch_*.py``.
"""

import threading

import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from videoprocessingframework_torch import models as tm
from videoprocessingframework_torch.models.graphed import (
    EAGER_RUNS,
    GraphedModule,
)

pytestmark = pytest.mark.cuda

#: family -> (builder, the benchmark's shape, a server bucket's shape)
_MODELS = {
    "resnet50": (lambda: tm.resnet50().to(memory_format=torch.channels_last),
                 (32, 224, 224, 3), None),
    "resnet18_like": (tm.resnet18_like, None, (4, 64, 64, 3)),
    "vit_s16": (lambda: tm.ViT(depth=12), (32, 224, 224, 3),
                (4, 224, 224, 3)),
}
_CASES = [(f, s) for f, (_, a, b) in sorted(_MODELS.items())
          for s in (a, b) if s is not None]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _model(family, cuda):
    torch.manual_seed(0)
    return _MODELS[family][0]().to(cuda).eval()


def _warm(m, x):
    """The eager runs before a capture, then the capture and a replay."""
    for _ in range(EAGER_RUNS):
        m(x)
    out = m(x)
    assert m.graph_stats["captures"] == 1
    return out


@pytest.mark.parametrize("family,shape", _CASES)
def test_replay_equals_eager(cuda, family, shape):
    m = _model(family, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    xs = [torch.randn(shape, device=cuda, generator=g) for _ in range(3)]
    with torch.no_grad():
        eager = [m(x) for x in xs[:EAGER_RUNS]]
        replayed = [m(x) for x in xs]
        want = [m._forward(x) for x in xs]
    assert m.graph_stats["eager"] == {"warmup": EAGER_RUNS}
    assert m.graph_stats["replays"] == 3
    for a, b in zip(eager, want):
        assert torch.equal(a, b)
    for got, w in zip(replayed, want):
        assert got.dtype == torch.float32 and got.shape == w.shape
        assert torch.equal(got, w)


def test_outputs_do_not_alias(cuda):
    m = _model("resnet18_like", cuda)
    x1 = torch.randn(4, 64, 64, 3, device=cuda)
    x2 = torch.randn(4, 64, 64, 3, device=cuda)
    with torch.no_grad():
        _warm(m, x1)
        a = m(x1)
        kept = a.clone()
        b = m(x2)
        torch.cuda.synchronize()
        assert a.data_ptr() != b.data_ptr()
        assert torch.equal(a, kept)
        assert torch.equal(b, m._forward(x2))
        assert not torch.equal(a, b)


def test_replaced_storage_is_captured_again(cuda):
    m = _model("resnet18_like", cuda)
    x = torch.randn(4, 64, 64, 3, device=cuda)
    with torch.no_grad():
        _warm(m, x)
        m.classifier.weight.data = 2 * m.classifier.weight.data
        for _ in range(EAGER_RUNS + 2):
            got = m(x)
        assert torch.equal(got, m._forward(x))
    s = m.graph_stats
    assert s["captures"] == 2 and s["replays"] == 3
    assert s["eager"] == {"warmup": 2 * EAGER_RUNS}


@pytest.mark.parametrize("family", ["resnet18_like", "vit_s16"])
def test_swapped_submodule_is_captured_again(cuda, family):
    m = _model(family, cuda)
    x = torch.randn(_MODELS[family][2], device=cuda)
    with torch.no_grad():
        before = _warm(m, x)
        c = m.classifier
        m.classifier = type(c)(c.in_features, 7).to(cuda).eval()
        outs = [m(x) for _ in range(EAGER_RUNS + 2)]
        want = m._forward(x)
    assert before.shape[1] == 1000
    for got in outs:
        assert got.shape == (x.shape[0], 7)
        assert torch.equal(got, want)
    s = m.graph_stats
    assert s["captures"] == 2 and s["replays"] == 3
    assert s["eager"] == {"warmup": 2 * EAGER_RUNS}


def test_in_place_update_read_by_replay(cuda):
    m = _model("vit_s16", cuda)
    x = torch.randn(4, 224, 224, 3, device=cuda)
    with torch.no_grad():
        before = _warm(m, x)
        m.classifier.bias.add_(1.0)
        m.block3.Dense_0.weight.mul_(0.5)
        got = m(x)
        assert torch.equal(got, m._forward(x))
        assert not torch.equal(got, before)
    assert m.graph_stats["captures"] == 1


def test_calls_from_another_stream(cuda):
    m = _model("resnet18_like", cuda)
    x1 = torch.randn(4, 64, 64, 3, device=cuda)
    x2 = torch.randn(4, 64, 64, 3, device=cuda)
    side = torch.cuda.Stream()
    with torch.no_grad():
        _warm(m, x1)
        a = m(x1)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            b = m(x2)
        torch.cuda.current_stream().wait_stream(side)
        c = m(x1)
        torch.cuda.synchronize()
        assert torch.equal(a, c)
        assert torch.equal(b, m._forward(x2))


def test_lock_held_runs_eager(cuda):
    m = _model("resnet18_like", cuda)
    x = torch.randn(4, 64, 64, 3, device=cuda)
    out = []

    def call():
        with torch.no_grad():
            out.append(m(x))

    with torch.no_grad():
        want = _warm(m, x)
    with m.graphs.lock:
        t = threading.Thread(target=call)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    assert torch.equal(out[0], want)
    assert m.graph_stats["eager"]["busy"] == 1


def test_graph_spans_inside_the_forward(cuda):
    m = _model("resnet18_like", cuda)
    x = torch.randn(4, 64, 64, 3, device=cuda)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as p:
        for _ in range(EAGER_RUNS + 2):
            m(x)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in p.events() if e.name.startswith("model.")]
    names = [s[0] for s in spans]
    assert names.count("model.forward") == EAGER_RUNS + 2
    assert names.count("model.graph_capture") == 1
    assert names.count("model.graph") == 2
    forwards = [s for s in spans if s[0] == "model.forward"]
    for s in spans:
        assert any(f[1] <= s[1] and s[2] <= f[2] for f in forwards), s


class _Syncing(GraphedModule):
    """A forward that reads a value back to the host, which no capture
    can hold."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(8))

    def _forward(self, x):
        return x * self.w * float(x.abs().sum() >= 0)


def test_failed_capture_stays_eager(cuda):
    m = _Syncing().to(cuda).eval()
    x = torch.randn(8, device=cuda)
    with torch.no_grad():
        outs = [m(x) for _ in range(EAGER_RUNS + 2)]
    for o in outs:
        assert torch.equal(o, x)
    s = m.graphs.stats
    assert s["captures"] == 0 and s["replays"] == 0
    assert s["eager"] == {"warmup": EAGER_RUNS, "capture_failed": 2}
    # the card is usable after the failed capture
    assert torch.equal(x + 1, (x + 1).cpu().to(cuda))
