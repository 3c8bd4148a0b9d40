"""The port's data × tensor parallel train step (parallel/train.py) on a
(2, 2) gloo mesh of four CPU ranks, against the JAX package's
``make_train_step`` on its (4, 2) mesh of the 8 virtual CPU devices and
against the port's own single-device step on the whole batch.

Setup: ``resnet18_like(num_classes=4)``, batch 8, float64 on both sides
(``jax.enable_x64``), Flax variables carried across with
``from_jax_variables`` (rounded to float32 first, as the map stores
them, so both sides start from the same numbers), SGD 0.05 momentum 0.9
and Adam 1e-3 (ε 1e-2, see tests/test_torch_train.py for why); then
video_vit_tiny with MixUp/CutMix soft labels and Adam.

The images are 64², not 32²: at 32² stage 4 runs at 1×1, its BatchNorm
normalises 8 values a channel, and three SGD-momentum steps grow the
float32 rounding of the classifier (float32 on both sides, Flax's
``Dense(dtype=float32)``) to 4e-4-1e-3 of a weight — the port's own
single-device step lies that far from JAX's after 3 steps, on every
seed tried. At 64² it lies 2e-6 from JAX.

Relative error is a tensor's largest difference over its largest
magnitude. Bars: JAX's sharded step within ``REL`` (1e-5,
test_torch_train.py's) in loss, accuracy, every parameter and
``batch_stats`` after 1 and 3 steps (1.9e-6 measured). The port's
single-device step within ``REL_SINGLE`` (5.1e-7 measured, SGD at step
3; 2.3e-8 after one step): the float32 classifier's gradient sums over
the batch (split over ``data``) and over the classes (split over
``model``) round in another order, and float64 carries that noise on.
Per-rank BatchNorm statistics or a tp× gradient miss by orders of
magnitude more. The ranks of a world agree exactly.
"""

import numpy as np
import pytest

from _torch_worlds import run_world

REL = 1e-5
REL_SINGLE = 2e-6
CLASSES = 4
STEPS = (1, 3)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _variables(model, x, seed):
    """Seeded Flax variables for ``model``, float64 values that are
    float32 numbers."""
    import jax

    shapes = jax.eval_shape(
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
        return a.astype(np.float32).astype(np.float64)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(shapes))


def _save_case(path, variables, x, labels):
    from videoprocessingframework_torch.models import from_jax_variables

    sd = {f"sd.{k}": v.numpy()
          for k, v in from_jax_variables(variables).items()}
    np.savez(path, x=x, labels=labels, **sd)
    return str(path)


def _jax_run(jmodel, variables, optimizer, batch, steps):
    """JAX's sharded step on the (4, 2) mesh: {step: (port state dict of
    numpy arrays, loss, accuracy)}."""
    import jax

    from videoprocessingframework_torch.models import from_jax_variables
    from videoprocessingframework_tpu.parallel import make_mesh, shard_batch
    from videoprocessingframework_tpu.parallel import train as jtrain

    mesh = make_mesh(8, ("data", "model"), shape=(4, 2))
    v = jtrain.shard_variables(mesh, variables)
    opt_state = optimizer.init(v["params"])
    step = jtrain.make_train_step(jmodel, mesh, optimizer)
    batch = shard_batch(batch, mesh)
    out = {}
    for k in range(1, max(steps) + 1):
        v, opt_state, metrics = step(v, opt_state, batch)
        if k in steps:
            sd = {n: t.numpy() for n, t in
                  from_jax_variables(jax.device_get(v)).items()}
            out[k] = (sd, float(metrics["loss"]), float(metrics["accuracy"]))
    return out


def _port_single(init, x, labels, make_opt, steps):
    """The port's single-device step on the whole batch."""
    import torch

    from videoprocessingframework_torch.models import resnet18_like
    from videoprocessingframework_torch.parallel import make_train_step

    model = resnet18_like(CLASSES, torch.float64).double()
    model.load_state_dict(init)
    step = make_train_step(model, make_opt(model.parameters()))
    out = {}
    for k in range(1, max(steps) + 1):
        m = step({"image": torch.from_numpy(x),
                  "label": torch.from_numpy(labels)})
        if k in steps:
            out[k] = ({n: t.numpy().copy() for n, t in
                       model.state_dict().items()},
                      m["loss"].item(), m["accuracy"].item())
    return out


def _sharded(res, key):
    r0 = res[0]
    sd = {k[len(key) + 1:]: v for k, v in r0.items()
          if k.startswith(key + ".")}
    return sd, float(r0[f"{key}_loss"]), float(r0[f"{key}_acc"])


def _compare(got, want, rel, what):
    sd, loss, acc = got
    wsd, wloss, wacc = want
    assert _rel(loss, wloss) <= rel, (what, loss, wloss)
    assert acc == wacc, what
    assert set(sd) == set(wsd), what
    keys = [k for k in sd if not k.endswith("num_batches_tracked")]
    worst = {k: _rel(sd[k], wsd[k]) for k in keys}
    name = max(worst, key=worst.get)
    assert worst[name] <= rel, (what, name, worst[name])
    return worst[name]


@pytest.fixture(scope="module")
def world_b(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from videoprocessingframework_tpu.models import resnet as jresnet
    from videoprocessingframework_tpu.models import vit as jvit
    from videoprocessingframework_tpu.ops.augment import mixup_cutmix

    d = tmp_path_factory.mktemp("b")
    with jax.enable_x64(True):
        jm = jresnet.resnet18_like(num_classes=CLASSES, dtype=jnp.float64)
        r = np.random.default_rng(4)
        x = r.standard_normal((8, 64, 64, 3))
        labels = r.integers(0, CLASSES, 8).astype(np.int32)
        variables = _variables(jm, x, 3)
        resnet = _save_case(d / "resnet.npz", variables, x, labels)

        jv = jvit.VideoViT(num_classes=CLASSES, dim=192, depth=4, heads=3,
                           temporal_depth=2, dtype=jnp.float64)
        vx = np.random.default_rng(0).random((4, 2, 32, 32, 3))
        mixed, soft = mixup_cutmix(vx, np.arange(4, dtype=np.int32),
                                   jax.random.PRNGKey(1),
                                   num_classes=CLASSES)
        mixed = np.asarray(mixed, np.float64)
        soft = np.asarray(soft, np.float64)
        vvars = _variables(jv, mixed, 6)
        vit = _save_case(d / "vit.npz", vvars, mixed, soft)
    res = run_world("train_steps", 4, d, resnet=resnet, vit=vit)
    return res, dict(jm=jm, variables=variables, x=x, labels=labels,
                     jv=jv, vvars=vvars, vx=mixed, soft=soft,
                     resnet_path=resnet)


def _optimizers(name):
    import optax
    import torch

    if name == "sgd":
        return (optax.sgd(0.05, momentum=0.9),
                lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9))
    return (optax.adam(1e-3, eps=1e-2),
            lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-2))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_dp_tp_resnet_step_matches_jax_and_single_device(world_b, opt):
    import jax
    import torch

    res, case = world_b
    jopt, topt = _optimizers(opt)
    with jax.enable_x64(True):
        want = _jax_run(case["jm"], case["variables"], jopt,
                        {"image": case["x"], "label": case["labels"]},
                        STEPS)
    init = {k[3:]: torch.from_numpy(v) for k, v in np.load(
        case["resnet_path"]).items() if k.startswith("sd.")}
    single = _port_single(init, case["x"], case["labels"], topt, STEPS)
    for k in STEPS:
        got = _sharded(res, f"{opt}{k}")
        _compare(got, want[k], REL, f"{opt} step {k} vs JAX")
        _compare(got, single[k], REL_SINGLE, f"{opt} step {k} vs single")
        # the step moved the parameters (else nothing is compared)
        assert max(_rel(got[0][n], init[n].numpy()) for n in got[0]
                   if not n.endswith("num_batches_tracked")) > 100 * REL
        # every rank holds the same state
        for r in res[1:]:
            np.testing.assert_array_equal(r[f"{opt}{k}_digest"],
                                          res[0][f"{opt}{k}_digest"])
            assert r[f"{opt}{k}_loss"] == res[0][f"{opt}{k}_loss"]


def test_statless_video_vit_soft_labels(world_b):
    """video_vit_tiny, MixUp/CutMix soft labels, Adam on the (2, 2) mesh:
    no BatchNorm state, losses fall over 15 steps, and one step (ε 1e-2)
    matches JAX's sharded step in float64."""
    import jax
    import optax

    res, case = world_b
    for r in res:
        assert int(r["vit_run_buffers"]) == 0
        losses = r["vit_run_losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with jax.enable_x64(True):
        want = _jax_run(case["jv"], case["vvars"], optax.adam(1e-3, eps=1e-2),
                        {"image": case["vx"], "label": case["soft"]}, (1,))
    sd, loss, _ = _sharded(res, "vit_cmp")
    wsd, wloss, _ = want[1]
    assert _rel(loss, wloss) <= REL
    worst = max(_rel(sd[k], wsd[k]) for k in sd)
    assert worst <= REL
