"""The slice end to end on the CPU: test.mp4 → port decode pool → port
FusedPipeline (normalized) → port ResNet18-like, against JAX pool → JAX
FusedPipeline (kernel="xla", compute="highest") → Flax apply, with the
weights carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from videoprocessingframework_tpu.core.enums import (
    ColorRange as JColorRange,
    ColorSpace as JColorSpace,
    PixelFormat as JPixelFormat,
)
from videoprocessingframework_tpu.io import NativeDecodePool as JaxPool
from videoprocessingframework_tpu.models import resnet as jresnet
from videoprocessingframework_tpu.ops.fused import (
    FusedPipeline as JaxPipeline,
)
from videoprocessingframework_torch.core.enums import PixelFormat
from videoprocessingframework_torch.io import NativeDecodePool
from videoprocessingframework_torch.models import (
    from_jax_variables,
    resnet18_like,
)
from videoprocessingframework_torch.ops.fused import FusedPipeline

OUT = (64, 64)  # (width, height)


def _variables(model, seed=0):
    variables = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, OUT[1], OUT[0], 3)), False)
    )
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("var", "scale"):
            return r.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (r.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * r.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(variables))


def test_slice_matches_jax_package(test_mp4):
    jm = jresnet.resnet18_like(num_classes=10, dtype=jnp.float32)
    variables = _variables(jm)

    jpool = JaxPool([test_mp4], batch_size=32, out_format=4,
                    plane_major=True)
    jpipe = JaxPipeline(JPixelFormat.YUV420, jpool.color_space,
                        jpool.color_range, OUT, output="normalized",
                        kernel="xla", compute="highest")
    want = [np.asarray(jm.apply(variables, np.asarray(x), train=False))
            for x in jpool.batches(jpipe, depth=2)]

    pool = NativeDecodePool([test_mp4], batch_size=32,
                            out_format=PixelFormat.YUV420, plane_major=True,
                            device="cpu")
    pipe = FusedPipeline(PixelFormat.YUV420, pool.color_space,
                         pool.color_range, OUT, output="normalized",
                         device="cpu")
    model = resnet18_like(num_classes=10, dtype=torch.float32).eval()
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = [model(x).numpy() for x in pool.batches(pipe, depth=2)]

    assert (int(pool.color_space), int(pool.color_range)) == \
        (int(JColorSpace.BT_709), int(JColorRange.MPEG))
    assert [g.shape for g in got] == [w.shape for w in want] == \
        [(32, 10)] * 3
    # both paths are float32 end to end; a rounding-boundary flip of a
    # normalized input moves no logit by more than this
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               rtol=1e-4, atol=1e-4)
