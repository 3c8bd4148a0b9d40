"""The port's ResNet against the Flax model, weights carried across with
``from_jax_variables``.

Every parameter and statistic is filled from a numpy generator: Flax's
init zeroes each ``bn3`` scale, which cancels every residual branch and
would hide a padding shift in ``conv2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.models import resnet as jresnet
from videoprocessingframework_torch.models import (
    from_jax_variables,
    resnet18_like,
    resnet50,
)


def _random_variables(model, shape, seed):
    variables = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(shape), False)
    )
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return r.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return r.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (r.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * r.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(variables))


def _pair(dtype_j, dtype_t, seed=0):
    jm = jresnet.resnet18_like(num_classes=10, dtype=dtype_j)
    variables = _random_variables(jm, (2, 64, 64, 3), seed)
    tm = resnet18_like(num_classes=10, dtype=dtype_t).eval()
    tm.load_state_dict(from_jax_variables(variables))
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, x, train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    return got, want


def test_resnet18_like_float32_matches_flax():
    got, want = _pair(jnp.float32, torch.float32)
    assert got.shape == want.shape == (2, 10)
    # float32 end to end; different conv summation orders
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_resnet18_like_bfloat16_close_to_flax():
    got, want = _pair(jnp.bfloat16, torch.bfloat16, seed=3)
    # bf16 keeps ~3 significant digits and the two frameworks round at
    # different places; the logits' scale is O(1)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.05 * scale


def test_same_padding_matches_flax_on_odd_and_even_inputs():
    """A 3×3 stride-2 SAME conv pads (0, 1) on even and (1, 1) on odd
    input sizes."""
    import flax.linen as fnn

    from videoprocessingframework_torch.models.resnet import SameConv2d

    r = np.random.default_rng(4)
    for n in (8, 9):
        x = r.standard_normal((1, n, n, 3)).astype(np.float32)
        conv = fnn.Conv(4, (3, 3), (2, 2), use_bias=False)
        k = r.standard_normal((3, 3, 3, 4)).astype(np.float32)
        want = np.asarray(conv.apply({"params": {"kernel": k}}, x))
        tc = SameConv2d(3, 4, 3, 2, dtype=torch.float32)
        tc.weight.data = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
        with torch.no_grad():
            got = tc(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-5, atol=1e-5)


def test_resnet50_shapes_and_names():
    m = resnet50()
    names = set(m.state_dict())
    assert "stage4_block3.conv3.weight" in names
    assert "stage2_block1.proj_conv.weight" in names
    assert m.classifier.weight.shape == (1000, 2048)
    assert sum(p.numel() for p in m.parameters()) == 25_557_032
    with pytest.raises(KeyError):
        from_jax_variables({"params": {"stem_conv": {"bogus": np.zeros(1)}}})
