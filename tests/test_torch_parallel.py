"""The port's parallel layer (parallel/mesh.py, multidevice.py,
multihost.py, the loaders' ``sharding=``) on gloo worlds of CPU ranks,
against the port's single-device paths and the JAX package's functions
on the 8 virtual CPU devices of tests/conftest.py.

Each world is one set of processes (``_torch_worlds.run_world``: a
``FileStore`` rendezvous in a temp dir, 60 s init timeout, a join
timeout after which the parent kills the world) run once per module;
the ranks import no JAX and write their results to ``.npz`` files, and
the tests below read them. Bars: the sharded paths equal the port's
single-device paths bit for bit; against the JAX package, ≤1 code
(``rgb_u8``, the JAX side at ``compute="highest"``, the port's float32).
"""

import numpy as np
import pytest
import torch

from _torch_worlds import run_world
from _torch_world_cases import fused, packed420
from videoprocessingframework_torch.core.enums import (
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.io import MjpegWriter
from videoprocessingframework_torch.parallel import mesh as pm

JAX_KW = dict(compute="highest")


@pytest.fixture(scope="module")
def world_a(tmp_path_factory):
    return run_world("mesh_and_pipelines", 4, tmp_path_factory.mktemp("a"))


def test_mesh_shape_and_shard_batch(world_a):
    want = np.arange(32, dtype=np.float32).reshape(8, 4)
    for r in world_a:
        assert tuple(r["mesh_shape"]) == (2, 2)
        assert list(r["mesh_names"]) == ["data", "model"]
        assert r["placements_ok"]
        np.testing.assert_array_equal(r["full"], want)
        i = int(r["data_index"])
        np.testing.assert_array_equal(r["local"], want[4 * i:4 * i + 4])
        # 7 rows over 2 data shards, 8 devices of a world of 4, and a
        # shape that is not the world
        assert r["indivisible_raises"]
        assert r["n_devices_raises"] and r["shape_raises"]


def test_make_mesh_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        pm.make_mesh(1)
    with pytest.raises(ValueError, match="cuda|cpu"):
        pm.make_mesh(1, device_type="tpu")


def test_sharded_video_pipeline_bit_exact(world_a):
    single = world_a[0]["single"]
    for r, res in enumerate(world_a):
        np.testing.assert_array_equal(res["sharded"], single)
        np.testing.assert_array_equal(res["sharded_2d"], single)
        # really sharded: each rank holds its own 4 frames
        np.testing.assert_array_equal(res["sharded_local"],
                                      single[4 * r:4 * r + 4])
        assert res["out_placements_ok"] and res["matches"]
        assert res["pipe_indivisible_raises"]


def test_sharded_video_pipeline_vs_jax(world_a):
    """≤1 code from the JAX package's ShardedVideoPipeline over its 8
    devices on the same 16 frames."""
    import jax

    from videoprocessingframework_tpu.core import enums as je
    from videoprocessingframework_tpu.ops.fused import FusedPipeline
    from videoprocessingframework_tpu.parallel.multidevice import (
        ShardedVideoPipeline,
    )

    assert len(jax.devices()) == 8
    post = FusedPipeline(je.PixelFormat.YUV420, je.ColorSpace.BT_709,
                         je.ColorRange.MPEG, out_size=(64, 32), **JAX_KW)
    want = np.asarray(ShardedVideoPipeline(post)(packed420(16, 64, 96)))
    got = world_a[0]["sharded"]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(int) - want).max() <= 1


def test_encode_feed_sharded_matches_single_device(world_a):
    assert all(r["feed_equal"] for r in world_a)


def _jax_sharded_names(jmodel, shape):
    """Port names of the weights JAX's make_param_shardings puts on
    ``model`` ((4, 2) mesh: tp = 2, as the port's (2, 2))."""
    import jax

    from videoprocessingframework_tpu.parallel import make_mesh
    from videoprocessingframework_tpu.parallel.train import (
        make_param_shardings,
    )

    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), np.zeros(shape, np.float32), train=False))
    specs = make_param_shardings(make_mesh(8, ("data", "model"), (4, 2)),
                                 shapes["params"])
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    out = []
    for path, sh in flat:
        names = [p.key for p in path]
        if "model" in tuple(sh.spec):
            assert names[-1] == "kernel"
            out.append(".".join(names[:-1]) + ".weight")
    return sorted(out)


def test_sharding_rules_match_jax_by_name(world_a):
    """The weights the port shards over ``model`` are JAX's, name by name
    after the port's weight map, for every bundled model; a classifier of
    3 (indivisible) or 2 (< 2·tp) outputs stays replicated."""
    import jax.numpy as jnp

    from videoprocessingframework_tpu.models import resnet as jresnet
    from videoprocessingframework_tpu.models import segmentation as jseg
    from videoprocessingframework_tpu.models import video as jvideo
    from videoprocessingframework_tpu.models import vit as jvit

    f32 = jnp.float32
    jmodels = {
        "resnet8": (jresnet.resnet18_like(8, f32), (1, 32, 32, 3)),
        "resnet3": (jresnet.resnet18_like(3, f32), (1, 32, 32, 3)),
        "resnet2": (jresnet.resnet18_like(2, f32), (1, 32, 32, 3)),
        "vit": (jvit.ViT(num_classes=7, patch=8, dim=64, depth=2, heads=4,
                         dtype=f32), (1, 32, 32, 3)),
        "video_vit": (jvit.VideoViT(num_classes=5, patch=8, dim=64, depth=1,
                                    heads=4, temporal_depth=1, dtype=f32),
                      (1, 2, 32, 32, 3)),
        "video_resnet": (jvideo.video_resnet18_like(5, dtype=f32),
                         (1, 2, 32, 32, 3)),
        "fcn": (jseg.FCNResNet(num_classes=6, stage_sizes=(1, 1, 1),
                               width=8, dtype=f32), (1, 40, 52, 3)),
    }
    got = world_a[0]
    for name, (jm, shape) in jmodels.items():
        want = _jax_sharded_names(jm, shape)
        assert list(got[f"rule_{name}"]) == want, name
    assert list(got["classifier_placements"]) == ["R", "S(0)"]
    assert int(got["classifier_local_rows"]) == 4
    assert "classifier.weight" not in set(got["rule_resnet3"])
    assert "classifier.weight" not in set(got["rule_resnet2"])


def test_sharded_infer_step_equals_single_device(world_a):
    """make_infer_step(model, mesh) on the (2, 2) mesh: logits sharded on
    dim 0, every bundled model's layers through the gathers, equal to the
    single-device step (the ResNets and the float32 FCN bit for bit; the
    transformers' float32 LayerNorms 1e-6 of the logits' scale)."""
    for r in world_a:
        for name in ("resnet8", "resnet3", "resnet2", "fcn"):
            assert float(r[f"infer_{name}"]) == 0.0, name
        for name in ("vit", "video_vit", "video_resnet"):
            assert float(r[f"infer_{name}"]) <= 1e-6, name
        assert tuple(r["infer_shape_resnet8"]) == (4, 8)
        assert tuple(r["infer_shape_fcn"]) == (2, 40, 52, 6)
        assert all(r[f"infer_placed_{n}"] for n in ("vit", "video_vit",
                                                   "video_resnet", "fcn"))


# ---- single process: MultiDeviceStreamPipeline --------------------------------


def test_multidevice_stream_pipeline(test_mp4, gt):
    """Round-robin over four "devices" (the CPU four times): every frame,
    bit-equal to the port's NativeDecodePool.batches, ≤1 code from the
    JAX package's MultiDeviceStreamPipeline over its 8 devices."""
    from videoprocessingframework_torch.io import NativeDecodePool
    from videoprocessingframework_torch.parallel import (
        MultiDeviceStreamPipeline,
    )

    post = fused()
    pipe = MultiDeviceStreamPipeline([test_mp4], post, batch_size=8,
                                     devices=["cpu"] * 4)
    outs = [o.numpy() for o in pipe.batches()]
    pipe.close()
    assert sum(o.shape[0] for o in outs) == gt["num_frames"]
    assert pipe.frames == gt["num_frames"]
    pool = NativeDecodePool([test_mp4], batch_size=8,
                            out_format=PixelFormat.YUV420, device="cpu")
    ref = np.concatenate([o.numpy() for o in pool.batches(post)])
    pool.close()
    got = np.concatenate(outs)
    np.testing.assert_array_equal(got, ref)

    from videoprocessingframework_tpu.core import enums as je
    from videoprocessingframework_tpu.ops.fused import FusedPipeline
    from videoprocessingframework_tpu.parallel.multidevice import (
        MultiDeviceStreamPipeline as JaxPipeline,
    )

    jpost = FusedPipeline(je.PixelFormat.YUV420, je.ColorSpace.BT_709,
                          je.ColorRange.MPEG, out_size=(64, 32), **JAX_KW)
    jpipe = JaxPipeline([test_mp4], jpost, batch_size=8)
    want = np.concatenate([np.asarray(o) for o in jpipe.batches()])
    jpipe.close()
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


def test_multidevice_refuses_a_bound_postproc(test_mp4):
    from videoprocessingframework_torch.parallel import (
        MultiDeviceStreamPipeline,
    )

    class Bound:
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="device='cuda'"):
        MultiDeviceStreamPipeline([test_mp4], Bound(),
                                  devices=["cuda:0", "cuda:1"])


# ---- 2 ranks: the loaders' sharding=, multi-host --------------------------------


@pytest.fixture(scope="module")
def world_c(tmp_path_factory, test_mp4):
    d = tmp_path_factory.mktemp("c")
    rng = np.random.default_rng(0)
    h, w, n = 64, 96, 12
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip((yy + xx) * 255 / (h + w) + rng.normal(0, 4, (n, h, w)),
                0, 255).astype(np.uint8)
    u = np.clip(128 + rng.normal(0, 6, (n, h // 2, w // 2)), 0,
                255).astype(np.uint8)
    with MjpegWriter(str(d / "clip.avi"), w, h, quality=90, container="avi",
                     device="cpu") as wr:
        wr.write_planes(y, u, 255 - u)
    return run_world("loaders", 2, d, mp4=test_mp4,
                     avi=str(d / "clip.avi")), str(d / "clip.avi")


LOADERS = ("video", "augmented", "host", "mjpeg", "bucketed")


def test_sharded_loaders_equal_unsharded_shards(world_c):
    """Each rank's local shard is the unsharded loader's batch at the
    same shard_index, bit for bit; the DTensor's global batch is both
    ranks' batches; labels come as a DTensor shard too."""
    res, _ = world_c
    for r in res:
        for name in LOADERS:
            assert r[f"{name}_placed"] and r[f"{name}_equal"], name
        assert r["video_labels_equal"] and r["host_labels_equal"]
        assert len({int(x[f"video_len"]) for x in res}) == 1


def test_sharded_loaders_vs_jax(world_c, test_mp4):
    """The ranks' shards against the JAX package's loaders at the same
    shard_index (≤1 code; HostClipLoader has no JAX counterpart, and
    JAX's augmentation draws from threefry, so those two are held to the
    port's unsharded loader above)."""
    from videoprocessingframework_tpu import data as jdata

    res, avi = world_c
    kw = dict(clip_len=2, batch_size=2, out_size=(32, 32), output="rgb_u8",
              drop_last=True, seed=5, workers=1, shard_count=2, **JAX_KW)
    for r, got in enumerate(res):
        for name, make in (
                ("video", lambda: jdata.VideoClipLoader(
                    [test_mp4], labels=[3], shard_index=r, **kw)),
                ("mjpeg", lambda: jdata.MjpegClipLoader(
                    avi, shard_index=r, **kw))):
            want = next(iter(make().epoch(0)))
            want = np.asarray(want[0] if isinstance(want, tuple) else want)
            local = got[f"{name}_local"]
            assert local.shape == want.shape
            assert np.abs(local.astype(int) - want).max() <= 1, name


def test_sharded_loader_lockstep_and_errors(world_c):
    """With sharding= every rank takes the same number of clips (9 and 9
    of 19, not 10 and 9), a batch that is not full raises on every rank,
    and shard_index/shard_count that disagree with the mesh raise."""
    res, _ = world_c
    assert [int(r["odd_len"]) for r in res] == [3, 3]
    assert sorted(int(r["odd_unsharded_len"]) for r in res) == [3, 4]
    assert all(r["ragged_raises"] and r["mismatch_raises"] for r in res)


def test_global_batch_assembler(world_c):
    res, _ = world_c
    want = np.concatenate([packed420(3, 16, 16, seed=r) for r in range(2)])
    for r in res:
        assert int(r["local_batch_multiple"]) == 1
        assert tuple(r["assembled_shape"]) == (6, 24, 16)
        np.testing.assert_array_equal(r["assembled"], want)


def test_multihost_video_pipeline(world_c, gt):
    """Each rank decodes its own sources (rank 1's end after 60 frames):
    both ranks stop after 7 full batches (ragged tail and the longer
    stream dropped), and every global batch is rank 0's and rank 1's
    single-device batches in rank order."""
    res, _ = world_c
    for r in res:
        assert r["multihost"].shape[0] == 7
        assert int(r["frames_local"]) == 7 * 8
        np.testing.assert_array_equal(r["multihost"], res[0]["multihost"])
    for k in range(7):
        glob = res[0]["multihost"][k]
        np.testing.assert_array_equal(glob[:8], res[0]["multihost_single"][k])
        np.testing.assert_array_equal(glob[8:], res[1]["multihost_single"][k])


# ---- a world of one: make_mesh's own world, serving ----------------------------


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    return run_world("world_of_one", 1, tmp_path_factory.mktemp("one"),
                     init=False)[0]


def test_make_mesh_starts_a_world_of_one(world_one):
    assert int(world_one["world"]) == 1
    assert str(world_one["backend"]) == "gloo"
    assert tuple(world_one["mesh_shape"]) == (1, 1)
    assert world_one["default_mesh_equal"]


def test_serving_sharded_infer_fn(world_one):
    """InferenceServer over make_infer_step(model, mesh) in a world of one
    (a server is one rank's: sharding its timing-driven batches over
    several ranks would need the others in lockstep): its DTensor logits
    are gathered for the requests and equal a direct call."""
    assert list(world_one["buckets"]) == [1, 2, 4]
    np.testing.assert_allclose(world_one["served"], world_one["direct"],
                               rtol=1e-5, atol=1e-5)


def test_serving_buckets_are_multiples_of_the_data_axis():
    from videoprocessingframework_torch.serving import InferenceServer

    def fn(batch):
        return batch

    fn.batch_multiple = 4
    with InferenceServer(fn, (2,), max_batch=12, device="cpu") as srv:
        assert srv.buckets == [4, 8, 12]
    with pytest.raises(ValueError, match="batch_multiple 4"):
        InferenceServer(fn, (2,), buckets=[4, 6], device="cpu")
