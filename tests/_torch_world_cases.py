"""The rank side of the parallel-layer tests (started by
``_torch_worlds.run_world``): each function runs on every rank of a gloo
world of CPU ranks and fills ``out`` with what the test compares. It
imports torch, numpy and the port, never JAX."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from videoprocessingframework_torch import models as tm
from videoprocessingframework_torch.core.enums import (
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.ops.fused import (
    FusedPipeline,
    encode_feed,
    encode_feed_gray,
)
from videoprocessingframework_torch.parallel import mesh as pm
from videoprocessingframework_torch.parallel.multidevice import (
    ShardedVideoPipeline,
    sharded_batch_matches_single_device,
)
from videoprocessingframework_torch.parallel.train import (
    full_state_dict,
    make_infer_step,
    make_param_shardings,
    make_train_step,
)

CPU = dict(device="cpu")


def packed420(n, h, w, seed=0):
    """``n`` seeded packed YUV420 frames (tests/test_parallel.py's)."""
    r = np.random.default_rng(seed)
    y = r.integers(0, 256, (n, h, w), np.uint8)
    u = r.integers(0, 256, (n, h // 2, w // 2), np.uint8)
    v = r.integers(0, 256, (n, h // 2, w // 2), np.uint8)
    return np.concatenate(
        [y.reshape(n, -1), u.reshape(n, -1), v.reshape(n, -1)], 1
    ).reshape(n, h * 3 // 2, w)


def fused(size=(64, 32)):
    return FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                         ColorRange.MPEG, out_size=size, kernel="torch",
                         **CPU)


def _raises(fn, exc=ValueError) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _is_batch_dtensor(t) -> bool:
    return isinstance(t, DTensor) and all(
        not isinstance(p, Shard) or p.dim == 0 for p in t.placements)


F64, F32 = torch.float64, torch.float32
#: the models of the sharding-rule checks: name → (build(dtype), input,
#: dtype); the FCN's float32 head takes float32 weights
RULE_MODELS = {
    "resnet8": (lambda dt: tm.resnet18_like(8, dt), (4, 32, 32, 3), F64),
    "resnet3": (lambda dt: tm.resnet18_like(3, dt), (4, 32, 32, 3), F64),
    "resnet2": (lambda dt: tm.resnet18_like(2, dt), (4, 32, 32, 3), F64),
    "vit": (lambda dt: tm.ViT(num_classes=7, patch=8, dim=64, depth=2,
                              heads=4, dtype=dt, image_size=(32, 32)),
            (4, 32, 32, 3), F64),
    "video_vit": (lambda dt: tm.VideoViT(
        num_classes=5, patch=8, dim=64, depth=1, heads=4, temporal_depth=1,
        dtype=dt, frames=2, image_size=(32, 32)), (2, 2, 32, 32, 3), F64),
    "video_resnet": (lambda dt: tm.video_resnet18_like(5, dtype=dt,
                                                       frames=2),
                     (2, 2, 32, 32, 3), F64),
    "fcn": (lambda dt: tm.FCNResNet(num_classes=6, stage_sizes=(1, 1, 1),
                                    width=8, dtype=dt), (2, 40, 52, 3), F32),
}


def mesh_and_pipelines(rank, world, params, out):
    """4 ranks: the mesh, shard_batch, ShardedVideoPipeline, encode_feed
    on a sharded batch, the sharding rules and the sharded infer step."""
    mesh = pm.make_mesh(4, ("data", "model"), shape=(2, 2), device_type="cpu")
    out["mesh_shape"] = tuple(mesh.shape)
    out["mesh_names"] = np.array(mesh.mesh_dim_names)
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    s = pm.shard_batch({"x": [x]}, mesh)["x"][0]
    out["placements_ok"] = s.placements == pm.batch_sharding(mesh).placements
    out["full"] = s.full_tensor().numpy()
    out["local"] = s.to_local().numpy()
    out["data_index"] = mesh.get_local_rank("data")
    out["indivisible_raises"] = _raises(lambda: pm.shard_batch(x[:7], mesh))
    out["n_devices_raises"] = _raises(lambda: pm.make_mesh(
        8, ("data", "model"), shape=(4, 2), device_type="cpu"))
    out["shape_raises"] = _raises(lambda: pm.make_mesh(
        4, ("data", "model"), shape=(3, 1), device_type="cpu"))

    flat = pm.make_mesh(4, ("data",), device_type="cpu")
    post = fused()
    packed = packed420(16, 64, 96)
    pipe = ShardedVideoPipeline(post, mesh=flat)
    got = pipe(packed)
    out["sharded"] = got.full_tensor().numpy()
    out["sharded_local"] = got.to_local().numpy()
    out["single"] = post(packed).numpy()
    out["out_placements_ok"] = (isinstance(got, DTensor)
                                and got.placements == (Shard(0),))
    out["pipe_indivisible_raises"] = _raises(lambda: pipe(packed[:6]))
    out["matches"] = sharded_batch_matches_single_device(post, packed, flat)
    # batch over data, replicated over model
    out["sharded_2d"] = ShardedVideoPipeline(post, mesh=mesh)(
        packed).full_tensor().numpy()

    rgb = np.random.default_rng(17).integers(0, 256, (8, 48, 64, 3),
                                             np.uint8)
    single = encode_feed(torch.from_numpy(rgb), out_h=24, out_w=32, **CPU)
    sharded = encode_feed(pm.shard_batch(rgb, flat), out_h=24, out_w=32)
    gray = encode_feed_gray(pm.shard_batch(rgb, flat), out_h=24, out_w=32)
    want_gray = encode_feed_gray(torch.from_numpy(rgb), out_h=24, out_w=32,
                                 **CPU)
    out["feed_equal"] = all(
        _is_batch_dtensor(a) and torch.equal(a.full_tensor(), b)
        for a, b in zip(sharded + (gray,), single + (want_gray,)))

    for name, (build, shape, dt) in RULE_MODELS.items():
        torch.manual_seed(0)
        ref = build(dt).to(dt)
        model = build(dt).to(dt)
        model.load_state_dict(ref.state_dict())
        specs = make_param_shardings(mesh, model)
        out[f"rule_{name}"] = np.array(sorted(
            k for k, v in specs.items()
            if any(isinstance(p, Shard) for p in v)), dtype=str)
        xs = np.random.default_rng(1).standard_normal(shape).astype(
            str(dt).split(".")[-1])
        want = make_infer_step(ref)(torch.from_numpy(xs))
        got = make_infer_step(model, mesh)(xs)
        out[f"infer_{name}"] = (got.full_tensor() - want).abs().max().item()
        out[f"infer_shape_{name}"] = tuple(got.shape)
        out[f"infer_placed_{name}"] = _is_batch_dtensor(got)
        if name == "resnet8":
            out["classifier_placements"] = np.array(
                [str(p) for p in specs["classifier.weight"]])
            out["classifier_local_rows"] = model.classifier.weight.shape[0]


def _digest(sd: dict) -> np.ndarray:
    """Per-tensor sums: equal on two ranks only if their states agree."""
    return np.array([v.double().sum().item() for v in sd.values()])


def _snapshot(out, key, model, metrics, rank):
    sd = full_state_dict(model)
    out[f"{key}_digest"] = _digest(sd)
    out[f"{key}_loss"] = metrics["loss"].item()
    out[f"{key}_acc"] = metrics["accuracy"].item()
    if rank == 0:
        for k, v in sd.items():
            out[f"{key}.{k}"] = v.numpy().copy()  # the live buffers move on


def train_steps(rank, world, params, out):
    """4 ranks, a (2, 2) mesh: the dp × tp ResNet step (SGD-momentum and
    Adam, float64, 3 steps) and the stat-less VideoViT step with soft
    labels (Adam, float64)."""
    mesh = pm.make_mesh(4, ("data", "model"), shape=(2, 2), device_type="cpu")
    case = dict(np.load(params["resnet"]))
    init = {k[3:]: torch.from_numpy(v) for k, v in case.items()
            if k.startswith("sd.")}
    batch = {"image": case["x"], "label": case["labels"]}
    opts = {"sgd": lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9),
            "adam": lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-2)}
    for name, make_opt in opts.items():
        model = tm.resnet18_like(4, torch.float64).double()
        model.load_state_dict(init)
        step = make_train_step(model, make_opt(model.parameters()), mesh)
        for k in range(1, 4):
            metrics = step(batch)
            if k in (1, 3):
                _snapshot(out, f"{name}{k}", model, metrics, rank)

    vit = dict(np.load(params["vit"]))
    init = {k[3:]: torch.from_numpy(v) for k, v in vit.items()
            if k.startswith("sd.")}
    batch = {"image": vit["x"], "label": vit["labels"]}
    for name, eps, steps in (("vit_cmp", 1e-2, 1), ("vit_run", 1e-8, 15)):
        model = tm.video_vit_tiny(4, dtype=torch.float64, frames=2,
                                  image_size=(32, 32)).double()
        model.load_state_dict(init)
        step = make_train_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-3, eps=eps), mesh)
        losses = [step(batch)["loss"].item() for _ in range(steps)]
        out[f"{name}_losses"] = losses
        out[f"{name}_buffers"] = len(list(model.buffers()))
        if name == "vit_cmp":
            _snapshot(out, name, model, {"loss": torch.tensor(losses[0]),
                                         "accuracy": torch.tensor(0.0)},
                      rank)


def loaders(rank, world, params, out):
    """2 ranks: the loaders' ``sharding=``, GlobalBatchAssembler and
    MultiHostVideoPipeline (each rank its own sources)."""
    from videoprocessingframework_torch.data import (
        AugmentSpec,
        BucketedClipLoader,
        HostClipLoader,
        MjpegClipLoader,
        VideoClipLoader,
    )
    from videoprocessingframework_torch.io import NativeDecodePool
    from videoprocessingframework_torch.parallel.multihost import (
        GlobalBatchAssembler,
        MultiHostVideoPipeline,
    )

    mesh = pm.make_mesh(2, ("data",), device_type="cpu")
    sh = pm.batch_sharding(mesh)
    mp4, avi = params["mp4"], params["avi"]
    kw = dict(clip_len=2, batch_size=2, out_size=(32, 32), output="rgb_u8",
              drop_last=True, seed=5)
    aug = AugmentSpec(crop=True, crop_scale=(0.5, 1.0), hflip=0.5,
                      brightness=0.2)
    cases = {
        "video": lambda **k: VideoClipLoader(mp4, labels=[3], workers=1,
                                             **kw, **k),
        "augmented": lambda **k: VideoClipLoader(mp4, augment=aug,
                                                 workers=1, **kw, **k),
        "host": lambda **k: HostClipLoader(64, 48, 2, 8, labels=[0, 1],
                                           **kw, **k),
        "mjpeg": lambda **k: MjpegClipLoader(avi, workers=1, **kw, **k),
        "bucketed": lambda **k: BucketedClipLoader([mp4], workers=1, **kw,
                                                   **k),
    }
    for name, make in cases.items():
        ld = make(sharding=sh)
        ref = make(shard_index=rank, shard_count=2, **CPU)
        got, want = next(iter(ld)), next(iter(ref))
        if isinstance(got, tuple):
            (got, labels), (want, want_labels) = got, want
            out[f"{name}_labels_equal"] = (
                _is_batch_dtensor(labels)
                and np.array_equal(labels.to_local().numpy(), want_labels))
        out[f"{name}_placed"] = _is_batch_dtensor(got) and tuple(
            got.shape) == (4,) + tuple(want.shape[1:])
        out[f"{name}_local"] = got.to_local().numpy()
        out[f"{name}_equal"] = torch.equal(got.to_local(), want)
        out[f"{name}_len"] = len(ld)
    # lockstep: 96 // 5 = 19 windows give the ranks 9 clips each (10 and
    # 9 unsharded)
    odd = dict(kw, clip_len=5, drop_last=False, batch_size=3, workers=1)
    out["odd_len"] = len(VideoClipLoader(mp4, sharding=sh, **odd))
    out["odd_unsharded_len"] = len(VideoClipLoader(
        mp4, shard_index=rank, shard_count=2, **odd, **CPU))
    # a batch that is not full raises on every rank (9 clips, batches of 4)
    ragged = VideoClipLoader(mp4, sharding=sh, **dict(odd, batch_size=4))
    out["ragged_raises"] = _raises(lambda: list(ragged))
    out["mismatch_raises"] = _raises(lambda: VideoClipLoader(
        mp4, sharding=sh, shard_index=1 - rank, shard_count=2, workers=1,
        **kw))

    asm = GlobalBatchAssembler(mesh)
    out["local_batch_multiple"] = asm.local_batch_multiple
    g = asm.global_batch(packed420(3, 16, 16, seed=rank))
    out["assembled"] = g.full_tensor().numpy()
    out["assembled_shape"] = tuple(g.shape)

    # rank 1's stream ends after 60 frames: 7 full batches, both ranks
    limit = (0, 60)[rank]
    post = fused()
    pipe = MultiHostVideoPipeline([mp4], post, mesh=mesh,
                                  batch_size_per_host=8,
                                  max_frames_per_stream=limit)
    outs = [o.full_tensor().numpy() for o in pipe.batches()]
    pipe.close()
    out["multihost"] = np.stack(outs)
    out["frames_local"] = pipe.frames_local
    pool = NativeDecodePool([mp4], batch_size=8,
                            out_format=PixelFormat.YUV420,
                            max_frames_per_stream=limit, **CPU)
    ref = [o.numpy() for o in pool.batches(post) if o.shape[0] == 8]
    pool.close()
    out["multihost_single"] = np.stack(ref[:len(outs)])


def world_of_one(rank, world, params, out):
    """No process group: make_mesh starts a world of one. The sharded
    pipeline on the default mesh and an InferenceServer over
    make_infer_step(model, mesh)."""
    from videoprocessingframework_torch.serving import InferenceServer

    mesh = pm.make_mesh(axes=("data", "model"), device_type="cpu")
    out["world"] = dist.get_world_size()
    out["backend"] = str(dist.get_backend())
    out["mesh_shape"] = tuple(mesh.shape)
    post = fused()
    packed = packed420(4, 64, 96)
    out["default_mesh_equal"] = torch.equal(
        ShardedVideoPipeline(post)(packed).full_tensor(), post(packed))

    torch.manual_seed(0)
    ref = tm.resnet18_like(4, torch.float32)
    model = tm.resnet18_like(4, torch.float32)
    model.load_state_dict(ref.state_dict())
    infer = make_infer_step(model, mesh)
    items = np.random.default_rng(3).standard_normal(
        (5, 32, 32, 3)).astype(np.float32)
    with InferenceServer(infer, (32, 32, 3), dtype=np.float32,
                         max_batch=4, max_wait_ms=5.0, **CPU) as srv:
        srv.warmup()
        out["buckets"] = srv.buckets
        got = np.stack([f.result(timeout=60).numpy()
                        for f in srv.submit_many(list(items))])
    out["served"] = got
    out["direct"] = make_infer_step(ref)(torch.from_numpy(items)).numpy()
