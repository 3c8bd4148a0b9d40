"""The port's ViT, VideoViT, VideoClassifier and FCN against the Flax
models, weights carried across with ``from_jax_variables``; the
torchvision-layout map against the JAX package's; checkpoints.

Every parameter and statistic is filled from a numpy generator (Flax's
init zeroes ``cls``, ``time_cls`` and each ``bn3`` scale, which would hide
a wrong layout), in each leaf's own dtype (the attention head's
``time_pos`` and ``cls_query`` are bf16 parameters in a bf16 Flax model).
"""

import contextlib
import copy
import pickle
import threading

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (numpy bf16 leaves)
import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.models import segmentation as jseg
from videoprocessingframework_tpu.models import video as jvideo
from videoprocessingframework_tpu.models import vit as jvit
from videoprocessingframework_tpu.models import weights as jweights
from videoprocessingframework_torch import models as tm
from videoprocessingframework_torch.models import graphed


def _random_variables(model, x, seed):
    variables = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, False))
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("var", "scale"):
            a = r.uniform(0.5, 1.5, leaf.shape)
        elif name == "kernel":
            a = r.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        else:
            a = 0.1 * r.standard_normal(leaf.shape)
        return a.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(variables))


def _compare(jmodel, tmodel, shape, seed):
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    variables = _random_variables(jmodel, x, seed)
    # strict: every leaf carried across, every torch parameter filled
    tmodel.load_state_dict(tm.from_jax_variables(variables))
    want = np.asarray(jmodel.apply(variables, x, train=False))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape
    return got, want


def _assert_f32(got, want):
    # float32 end to end on both sides; summation orders differ
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _assert_bf16(got, want):
    # bf16 keeps ~3 significant digits and the two frameworks round at
    # different places; judged against the logits' scale
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def _vit_pair(dtype_j, dtype_t, image):
    kw = dict(num_classes=7, patch=8, dim=64, depth=2, heads=4)
    return (jvit.ViT(dtype=dtype_j, **kw),
            tm.ViT(dtype=dtype_t, image_size=image, **kw))


# 32×32 takes no padding; 36×40 pads the patchify conv (SAME: 2/2 rows)
@pytest.mark.parametrize("image", [(32, 32), (36, 40)])
def test_vit_float32_matches_flax(image):
    jm, t = _vit_pair(jnp.float32, torch.float32, image)
    _assert_f32(*_compare(jm, t, (2,) + image + (3,), seed=0))


def test_vit_bfloat16_close_to_flax():
    jm, t = _vit_pair(jnp.bfloat16, torch.bfloat16, (32, 32))
    _assert_bf16(*_compare(jm, t, (2, 32, 32, 3), seed=1))


def test_vit_small_shapes_and_names():
    m = tm.vit_small()
    names = set(m.state_dict())
    for n in ("cls", "pos_embed", "patchify.bias", "block5.attn.out.weight",
              "block0.LayerNorm_1.weight", "block3.Dense_1.bias",
              "LayerNorm_0.bias", "classifier.weight"):
        assert n in names, n
    assert m.pos_embed.shape == (1, 197, 384)
    # the Flax model's parameter count at 224² (dim 384, depth 6)
    jm = jvit.vit_small()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), False))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in m.parameters()) == want
    with pytest.raises(ValueError, match="built for"):
        m(torch.zeros(1, 32, 32, 3))


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)])
def test_video_vit_matches_flax(dtypes):
    kw = dict(num_classes=5, patch=8, dim=64, depth=1, heads=4,
              temporal_depth=1)
    jm = jvit.VideoViT(dtype=dtypes[0], **kw)
    t = tm.VideoViT(dtype=dtypes[1], frames=3, image_size=(32, 32), **kw)
    got, want = _compare(jm, t, (2, 3, 32, 32, 3), seed=2)
    (_assert_f32 if dtypes[1] == torch.float32 else _assert_bf16)(got, want)


@pytest.mark.parametrize("temporal", ["mean", "last", "attention"])
@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)])
def test_video_classifier_matches_flax(temporal, dtypes):
    jm = jvideo.video_resnet18_like(num_classes=5, temporal=temporal,
                                    dtype=dtypes[0])
    t = tm.video_resnet18_like(num_classes=5, temporal=temporal,
                               dtype=dtypes[1], frames=3)
    got, want = _compare(jm, t, (2, 3, 32, 32, 3), seed=3)
    (_assert_f32 if dtypes[1] == torch.float32 else _assert_bf16)(got, want)


def test_video_classifier_rejects_bad_input():
    m = tm.video_resnet18_like(frames=3)
    with pytest.raises(ValueError, match=r"\[B, T, H, W, C\]"):
        m(torch.zeros(3, 32, 32, 3))
    with pytest.raises(ValueError, match="3-frame"):
        m(torch.zeros(1, 4, 32, 32, 3))
    with pytest.raises(ValueError, match="temporal head"):
        tm.video_resnet18_like(temporal="max")


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)])
def test_fcn_matches_flax(dtypes):
    kw = dict(num_classes=5, stage_sizes=(1, 1, 1), width=8)
    jm = jseg.FCNResNet(dtype=dtypes[0], **kw)
    t = tm.FCNResNet(dtype=dtypes[1], **kw)
    # 40×52: the stem and stride-2 blocks take odd and even sizes, the
    # upsample a non-integer ratio (7 → 52)
    got, want = _compare(jm, t, (2, 40, 52, 3), seed=4)
    assert got.shape == (2, 40, 52, 5)
    (_assert_f32 if dtypes[1] == torch.float32 else _assert_bf16)(got, want)


def _torchvision_resnet50_state_dict(seed=5, num_classes=1000):
    """Seeded numpy state_dict in torchvision's ResNet-50 layout."""
    r = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = r.standard_normal(
            (cout, cin, k, k)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = r.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = r.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_mean"] = r.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_var"] = r.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(0, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for i, n in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(n):
            p = f"layer{i + 1}.{j}"
            conv(f"{p}.conv1", f, cin, 1)
            bn(f"{p}.bn1", f)
            conv(f"{p}.conv2", f, f, 3)
            bn(f"{p}.bn2", f)
            conv(f"{p}.conv3", 4 * f, f, 1)
            bn(f"{p}.bn3", 4 * f)
            if j == 0:
                conv(f"{p}.downsample.0", 4 * f, cin, 1)
                bn(f"{p}.downsample.1", 4 * f)
            cin = 4 * f
    sd["fc.weight"] = r.standard_normal((num_classes, 2048)).astype(
        np.float32)
    sd["fc.bias"] = r.standard_normal(num_classes).astype(np.float32)
    return sd


def test_load_torch_resnet50_matches_jax_map():
    sd = _torchvision_resnet50_state_dict()
    via_jax = tm.from_jax_variables(jax.device_get(
        jweights.load_torch_resnet50(sd, dtype=jnp.float32)))
    direct = tm.load_torch_resnet50(
        {k: torch.from_numpy(v) for k, v in sd.items()})
    assert set(direct) == set(via_jax) == set(tm.resnet50().state_dict())
    for k in direct:
        assert torch.equal(direct[k], via_jax[k]), k
    tm.resnet50().load_state_dict(direct)
    with pytest.raises(ValueError, match="classes"):
        tm.load_torch_resnet50(sd, num_classes=10)
    with pytest.raises(KeyError):
        tm.load_torch_resnet50({"layer1.0.relu.weight": np.zeros(1)})


def test_checkpoint_round_trip(tmp_path):
    m = tm.vit_tiny(num_classes=3, image_size=(32, 32))
    state = {"model": m.state_dict(), "step": 7}
    path = tmp_path / "ckpt" / "vit.pt"
    tm.save_checkpoint(str(path), state)
    back = tm.load_checkpoint(str(path))
    assert back["step"] == 7
    for k, v in m.state_dict().items():
        assert torch.equal(back["model"][k], v), k
    like = {"model": {k: v.to(torch.bfloat16)
                      for k, v in m.state_dict().items()}}
    placed = tm.load_checkpoint(str(path), like=like)
    assert placed["model"]["cls"].dtype == torch.bfloat16
    wrong = {"model": {"cls": torch.zeros(2)}}
    with pytest.raises(ValueError, match="shape"):
        tm.load_checkpoint(str(path), like=wrong)


# The models' CUDA-graph replay (models/graphed.py): every call it may not
# replay runs the eager forward unchanged and is counted by its reason.
# The replays themselves run on the card (tests/test_torch_graphed.py).

_GRAPHED = {
    "resnet": lambda: tm.resnet18_like(num_classes=5),
    "vit": lambda: tm.ViT(num_classes=5, patch=8, dim=32, depth=1, heads=2,
                          image_size=(32, 32)),
}


def _call_eager_case(m, x, reason):
    """``(model(x), model._forward(x))`` in the state that makes the call
    ineligible for ``reason``."""
    if reason == "compiling":
        with torch.no_grad():
            got = torch.export.export(m, (x,)).module()(x)
            return got, m._forward(x)
    if reason == "mode":
        from torch.utils.flop_counter import FlopCounterMode

        with torch.no_grad():
            with FlopCounterMode(display=False) as fc:
                got = m(x)
            assert fc.get_total_flops() > 0  # the mode saw the eager ops
            return got, m._forward(x)
    if reason == "training":
        m.train()
    grad = torch.enable_grad() if reason == "grad" else torch.no_grad()
    cast = torch.autocast("cpu", dtype=torch.bfloat16) \
        if reason == "autocast" else contextlib.nullcontext()
    with grad, cast:
        return m(x), m._forward(x)


@pytest.mark.parametrize("reason", ["cpu", "grad", "training", "autocast",
                                    "compiling", "mode"])
@pytest.mark.parametrize("family", sorted(_GRAPHED))
def test_graph_ineligible_calls_run_eager(family, reason):
    torch.manual_seed(0)
    m = _GRAPHED[family]().eval()
    x = torch.randn(2, 32, 32, 3)
    got, want = _call_eager_case(m, x, reason)
    assert torch.equal(got, want)
    assert m.graph_stats == {"captures": 0, "replays": 0,
                             "eager": {reason: 1}}
    assert len(m.graphs) == 0


_MOVES = {
    "to_dtype": lambda m: m.to(torch.float32),
    "channels_last": lambda m: m.to(memory_format=torch.channels_last),
    "to_empty": lambda m: m.to_empty(device="cpu"),
}


@pytest.mark.parametrize("move", sorted(_MOVES))
@pytest.mark.parametrize("family", sorted(_GRAPHED))
def test_graph_cache_dropped_by_apply(family, move):
    m = _GRAPHED[family]().eval()
    entry = graphed._Entry()
    entry.graph = object()
    m.graphs.entries["signature"] = entry
    m.graphs.state = ()
    assert len(m.graphs) == 1
    _MOVES[move](m)
    assert len(m.graphs) == 0 and m.graphs.state is None


@pytest.mark.parametrize("family", sorted(_GRAPHED))
def test_graph_signatures_capped(family, monkeypatch):
    """Past MAX_GRAPHS signatures a call runs eagerly as ``cap``; the
    tracked ones go on counting their eager runs towards a capture."""
    monkeypatch.setattr(graphed, "_ineligible", lambda model, x: None)
    m = _GRAPHED[family]().eval()
    n = graphed.MAX_GRAPHS
    with torch.no_grad():
        for b in range(1, n + 2):
            x = torch.randn(b, 32, 32, 3)
            assert torch.equal(m(x), m._forward(x))
        m(torch.randn(1, 32, 32, 3))
    assert len(m.graphs.entries) == n and len(m.graphs) == 0
    assert m.graph_stats["eager"] == {"warmup": n + 1, "cap": 1}


@pytest.mark.parametrize("family", sorted(_GRAPHED))
def test_graph_lock_held_runs_eager(family, monkeypatch):
    monkeypatch.setattr(graphed, "_ineligible", lambda model, x: None)
    m = _GRAPHED[family]().eval()
    x = torch.randn(2, 32, 32, 3)
    out = []
    with torch.no_grad(), m.graphs.lock:
        t = threading.Thread(target=lambda: out.append(m(x)))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert torch.equal(out[0], m._forward(x))
    assert m.graph_stats["eager"] == {"busy": 1}


def test_graph_flags_host_work_and_training():
    m = tm.resnet18_like(num_classes=5).eval()

    def reason():
        found, ptrs = graphed._walk(m)
        return found if ptrs is None else None

    assert reason() is None
    h = m.register_forward_hook(lambda *a: None)  # runs outside forward
    assert reason() is None
    h.remove()
    h = m.stage1_block1.conv1.register_forward_pre_hook(lambda *a: None)
    assert reason() == "hooks"
    h.remove()
    h = torch.nn.modules.module.register_module_forward_hook(
        lambda *a: None)
    try:
        assert reason() == "hooks"
    finally:
        h.remove()
    m.stem_bn.forward = m.stem_bn.forward
    assert reason() == "hooks"
    del m.stem_bn.forward
    m.stage2_block1.bn2.train()
    assert reason() == "training"
    m.eval()
    assert reason() is None


def test_graph_storage_tracks_replaced_not_updated():
    m = tm.resnet18_like(num_classes=5).eval()
    modules, before = graphed._walk(m)
    assert sorted(map(id, modules)) == sorted(map(id, m.modules()))
    assert len(before) == len(m.state_dict())
    with torch.no_grad():
        m.classifier.bias.add_(1.0)
        m.stem_bn.running_var.mul_(2.0)
    m.load_state_dict(m.state_dict())
    assert graphed._walk(m) == (modules, before)
    m.classifier.weight.data = m.classifier.weight.data.clone()
    assert graphed._walk(m)[1] != before
    before = graphed._walk(m)[1]
    m.load_state_dict({k: v.clone() for k, v in m.state_dict().items()},
                      assign=True)
    assert graphed._walk(m)[1] != before


def _swap_classifier(m):
    c = m.classifier
    m.classifier = type(c)(c.in_features, c.out_features + 1).eval()


#: changes after a capture -> whether they drop the model's graphs
_CHANGES = {
    "swap_module": (_swap_classifier, True),
    "replace_storage": (lambda m: setattr(m.classifier.weight, "data",
                                          m.classifier.weight.data.clone()),
                        True),
    "assign_state": (lambda m: m.load_state_dict(
        {k: v.clone() for k, v in m.state_dict().items()}, assign=True),
        True),
    "update_in_place": (lambda m: m.classifier.bias.data.add_(1.0), False),
}


@pytest.mark.parametrize("change", sorted(_CHANGES))
@pytest.mark.parametrize("family", sorted(_GRAPHED))
def test_graph_cache_dropped_when_model_changes(family, change, monkeypatch):
    """A submodule swapped or a storage replaced after a capture drops
    the graphs (the next call starts the eager runs again, and returns
    the changed model's output); an in-place update keeps them."""
    monkeypatch.setattr(graphed, "_ineligible", lambda model, x: None)
    m = _GRAPHED[family]().eval()
    x = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        m(x)  # one eager run of the signature
    entry = graphed._Entry()
    entry.graph = object()  # a capture of another signature
    m.graphs.entries["signature"] = entry
    m.graphs.modules, m.graphs.state = graphed._walk(m)
    fn, drops = _CHANGES[change]
    fn(m)
    with torch.no_grad():
        got = m(x)
        assert torch.equal(got, m._forward(x))
    assert got.shape[1] == (6 if change == "swap_module" else 5)
    assert len(m.graphs) == (0 if drops else 1)
    assert (m.graphs.state is None) == drops
    # after a drop the signature's eager runs count from the start again
    assert len(m.graphs.entries) == (1 if drops else 2)
    assert m.graphs.entries[next(iter(m.graphs.entries))].runs == \
        (1 if drops else 2)
    assert m.graph_stats["eager"] == {"warmup": 2}


@pytest.mark.parametrize("switch", [
    "allow_tf32", "allow_bf16_reduced_precision_reduction",
    "allow_fp16_reduced_precision_reduction"])
def test_graph_key_follows_matmul_switches(switch, monkeypatch):
    """A switch that changes what cuBLAS computes gives a call another
    signature, so the graph captured under the old setting is not
    replayed under the new one."""
    monkeypatch.setattr(graphed, "_ineligible", lambda model, x: None)
    m = _GRAPHED["vit"]().eval()
    x = torch.randn(2, 32, 32, 3)
    matmul = torch.backends.cuda.matmul
    before = graphed._switches()
    with torch.no_grad():
        m(x)
        monkeypatch.setattr(matmul, switch, not getattr(matmul, switch))
        assert graphed._switches() != before
        m(x)
    assert len(m.graphs.entries) == 2


@pytest.mark.parametrize("copy_fn", ["deepcopy", "pickle"])
def test_graph_cache_not_copied(copy_fn):
    m = tm.vit_tiny(num_classes=3, image_size=(32, 32)).eval()
    entry = graphed._Entry()
    entry.graph = object()
    m.graphs.entries["signature"] = entry
    c = copy.deepcopy(m) if copy_fn == "deepcopy" \
        else pickle.loads(pickle.dumps(m))
    assert len(c.graphs) == 0 and c.graphs is not m.graphs
    assert c.graphs.lock is not m.graphs.lock
    x = torch.randn(1, 32, 32, 3)
    with torch.no_grad():
        assert torch.equal(c(x), m(x))
