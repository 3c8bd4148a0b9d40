"""The port's train step against the JAX package's ``make_train_step``
(optax) on a one-device mesh: Flax variables carried across with
``from_jax_variables``, one step with SGD-momentum and one with Adam on
``resnet18_like`` (32², 4 classes, batch 8), soft labels on a float32
VideoViT-tiny; the training BatchNorm's statistics against Flax's; a
``torch.save`` of model + optimizer + loader resuming bit-equal.

Relative error here is a tensor's largest difference over its largest
magnitude. The ResNet step compares everything — loss, accuracy, updated
parameters and ``batch_stats`` — within 1e-5 with both sides in float64
(the classifier computes in float32 on both, as Flax's ``Dense(dtype=
float32)``). In float32 it compares what the forward pass gives (loss
within 1e-4, accuracy, batch_stats within 1e-4): training BatchNorm at
1×1 spatial size takes E[x²]−E[x]² over a few values a channel, where
float32 loses digits on both sides alike (at batch 4, JAX's own float32
loss lies 4.1e-5 from its float64 one), and JAX's jitted float32
gradient differs from its own eager one by up to 6.5% of a tensor's
largest gradient at batch 16, so float32 parameters after the update
hold no comparison. Flax, optax and the JAX package are imported inside
the tests, so the file collects on a machine without them.
"""

import numpy as np
import pytest
import torch

from videoprocessingframework_torch.models import (
    from_jax_variables,
    resnet18_like,
    video_vit_tiny,
)
from videoprocessingframework_torch.models.resnet import BatchNorm
from videoprocessingframework_torch.parallel import (
    make_infer_step,
    make_train_step,
)

REL = 1e-5
#: float32 forward (loss, batch_stats) against JAX's float32 forward
REL_F32 = 1e-4
CLASSES = 4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _random_variables(model, x, seed, dtype=np.float32):
    import jax

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
        return a.astype(dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(variables))


def _jax_step(jmodel, variables, optimizer, x, labels):
    """One step of the JAX package's make_train_step on a 1-device mesh."""
    import jax

    from videoprocessingframework_tpu.parallel import make_mesh
    from videoprocessingframework_tpu.parallel import train as jtrain

    step = jtrain.make_train_step(jmodel, make_mesh(1), optimizer)
    opt_state = optimizer.init(variables["params"])
    new_vars, _, metrics = step(variables, opt_state,
                                {"image": x, "label": labels})
    return jax.device_get(new_vars), {k: float(v)
                                      for k, v in metrics.items()}


def _compare_step(jmodel, tmodel, variables, x, labels, jopt, topt_fn,
                  params=True, rel=REL):
    """One step on each side from the same variables; compares loss,
    accuracy, batch_stats and (with ``params``) the updated parameters."""
    tmodel.load_state_dict(from_jax_variables(variables))
    step = make_train_step(tmodel, topt_fn(tmodel.parameters()))
    got = step({"image": torch.from_numpy(x),
                "label": torch.from_numpy(labels)})
    want_vars, want = _jax_step(jmodel, variables, jopt, x, labels)
    assert got["loss"].dim() == 0 and got["accuracy"].dim() == 0
    assert _rel(got["loss"].item(), want["loss"]) <= rel
    assert got["accuracy"].item() == want["accuracy"]
    want_sd = from_jax_variables(want_vars)
    sd = tmodel.state_dict()
    assert set(sd) == set(want_sd)
    keys = [k for k in sd if not k.endswith("num_batches_tracked")
            and (params or k.split(".")[-1] in ("running_mean",
                                                "running_var"))]
    worst = {k: _rel(sd[k], want_sd[k]) for k in keys}
    name = max(worst, key=worst.get)
    assert worst[name] <= rel, (name, worst[name])
    # the step moved them (else the comparison proves nothing)
    before = from_jax_variables(variables)
    assert max(_rel(sd[k], before[k]) for k in keys) > 10 * rel
    return got


def _resnet_case(dtype, seed=0, batch=8):
    import jax.numpy as jnp

    from videoprocessingframework_tpu.models import resnet as jresnet

    jm = jresnet.resnet18_like(num_classes=CLASSES, dtype=jnp.dtype(dtype))
    r = np.random.default_rng(seed + 1)
    x = r.standard_normal((batch, 32, 32, 3)).astype(dtype)
    labels = r.integers(0, CLASSES, batch).astype(np.int32)
    return jm, _random_variables(jm, x, seed, dtype), x, labels


def _optimizers(name):
    import optax

    if name == "sgd":
        return (optax.sgd(0.05, momentum=0.9),
                lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9))
    # ε well above the gradients' noise (the classifier computes in
    # float32, and training BatchNorm's backward amplifies it): Adam's
    # first step is lr·g/(|g|+ε), ±lr for |g| ≫ ε, so at ε=1e-8 a gradient
    # within noise of 0 flips a whole step (measured: 1.1% of a kernel's
    # largest weight); at ε=1e-2 the two sides agree to 3.1e-6
    return (optax.adam(1e-3, eps=1e-2),
            lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-2))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_resnet_step_matches_optax_float64(opt):
    import jax

    tm = resnet18_like(num_classes=CLASSES, dtype=torch.float64).double()
    with jax.enable_x64(True):
        jm, variables, x, labels = _resnet_case(np.float64, seed=3)
        _compare_step(jm, tm, variables, x, labels, *_optimizers(opt))


def test_resnet_step_matches_optax_float32():
    jm, variables, x, labels = _resnet_case(np.float32)
    tm = resnet18_like(num_classes=CLASSES, dtype=torch.float32)
    _compare_step(jm, tm, variables, x, labels, *_optimizers("sgd"),
                  params=False, rel=REL_F32)


def test_soft_labels_on_video_vit_tiny():
    """Stat-less model (no batch_stats) with MixUp-style soft targets."""
    import jax.numpy as jnp
    import optax

    from videoprocessingframework_tpu.models import vit as jvit

    jm = jvit.VideoViT(num_classes=CLASSES, dim=192, depth=4, heads=3,
                       temporal_depth=2, dtype=jnp.float32)
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
    lam = np.float32(0.7)
    hard = np.eye(CLASSES, dtype=np.float32)[[1, 3]]
    labels = lam * hard + (1 - lam) * hard[::-1]
    variables = _random_variables(jm, x, 6)
    assert "batch_stats" not in variables
    tm = video_vit_tiny(CLASSES, dtype=torch.float32, frames=2,
                        image_size=(32, 32))
    _compare_step(jm, tm, variables, x, labels,
                  optax.sgd(0.05, momentum=0.9),
                  lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9))


def test_training_batchnorm_matches_flax_statistics():
    """Batch of 2 at 32²: the last stage holds 2×1×1 values a channel,
    where torch's F.batch_norm (unbiased running variance) would fold in
    twice Flax's variance. Outputs and running statistics vs Flax."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    r = np.random.default_rng(8)
    x = r.standard_normal((2, 1, 1, 6)).astype(np.float32) * 3 + 1
    bn = nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": r.uniform(0.5, 1.5, 6).astype(
        np.float32), "bias": r.standard_normal(6).astype(np.float32)},
        "batch_stats": {"mean": r.standard_normal(6).astype(np.float32),
                        "var": r.uniform(0.5, 1.5, 6).astype(np.float32)}}
    want, state = bn.apply(variables, x, use_running_average=False,
                           mutable=["batch_stats"])
    want_stats = jax.device_get(state["batch_stats"])

    tbn = BatchNorm(6, dtype=torch.float32).train()
    tbn.weight.data = torch.from_numpy(variables["params"]["scale"])
    tbn.bias.data = torch.from_numpy(variables["params"]["bias"])
    tbn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
    tbn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(got.detach(), want) <= REL
    assert _rel(tbn.running_mean, want_stats["mean"]) <= REL
    assert _rel(tbn.running_var, want_stats["var"]) <= REL
    # torch's own training BatchNorm folds in the unbiased variance
    ref = torch.nn.BatchNorm2d(6, eps=1e-5, momentum=0.1).train()
    ref.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    ref(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel(ref.running_var, want_stats["var"]) > 100 * REL
    # inference mode normalises by the running statistics
    tbn.eval()
    with torch.no_grad():
        inf = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
    want_inf = bn.apply({"params": variables["params"],
                         "batch_stats": want_stats}, x,
                        use_running_average=True)
    assert _rel(inf.permute(0, 2, 3, 1), want_inf) <= REL


def test_infer_step_is_eval_and_no_grad():
    tm = resnet18_like(num_classes=CLASSES, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    before = tm.stem_bn.running_mean.clone()
    logits = make_infer_step(tm)(x)
    assert logits.shape == (2, CLASSES) and not logits.requires_grad
    assert not tm.training
    assert torch.equal(tm.stem_bn.running_mean, before)


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """torch.save of model + optimizer + loader state; a fresh model,
    optimizer and loader loaded from it take the same next steps, bit for
    bit (CPU)."""
    from videoprocessingframework_torch.data import HostClipLoader

    def fresh():
        torch.manual_seed(0)
        model = resnet18_like(num_classes=CLASSES, dtype=torch.float32)
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        loader = HostClipLoader(48, 32, n_streams=2, frames_per_stream=12,
                                clip_len=1, batch_size=2, out_size=(32, 32),
                                labels=[1, 3], seed=4, device="cpu")
        return model, opt, loader

    def run(model, opt, it, n):
        step = make_train_step(model, opt)
        out = []
        for _ in range(n):
            x, labels = next(it)
            out.append(step({"image": x[:, 0], "label": labels})["loss"])
        return out

    model, opt, loader = fresh()
    it = loader.epoch(0)
    run(model, opt, it, 2)
    path = tmp_path / "ckpt.pt"
    torch.save({"model": model.state_dict(), "opt": opt.state_dict(),
                "loader": loader.state_dict()}, path)
    want = run(model, opt, it, 3)
    want_sd = model.state_dict()

    model2, opt2, loader2 = fresh()
    ckpt = torch.load(path, weights_only=True)
    model2.load_state_dict(ckpt["model"])
    opt2.load_state_dict(ckpt["opt"])
    loader2.load_state_dict(ckpt["loader"])
    got = run(model2, opt2, iter(loader2), 3)
    assert [g.item() for g in got] == [w.item() for w in want]
    for k, v in model2.state_dict().items():
        assert torch.equal(v, want_sd[k]), k


@pytest.mark.cuda
def test_train_step_cuda_matches_cpu():
    """One float32 step (TF32 off) on the card equals the CPU step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    cpu = resnet18_like(num_classes=CLASSES, dtype=torch.float32)
    gpu = resnet18_like(num_classes=CLASSES, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    x = torch.randn(4, 32, 32, 3)
    labels = torch.tensor([0, 1, 2, 3])
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = make_train_step(gpu, torch.optim.SGD(
            gpu.parameters(), lr=0.05, momentum=0.9))(
            {"image": x.cuda(), "label": labels.cuda()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    want = make_train_step(cpu, torch.optim.SGD(
        cpu.parameters(), lr=0.05, momentum=0.9))(
        {"image": x, "label": labels})
    assert got["loss"].is_cuda
    assert _rel(got["loss"].item(), want["loss"].item()) <= 1e-4
    for (k, a), b in zip(gpu.state_dict().items(), cpu.state_dict().values()):
        if a.is_floating_point():
            assert _rel(a.cpu(), b) <= 1e-3, k
