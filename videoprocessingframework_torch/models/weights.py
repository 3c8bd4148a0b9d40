"""Carry weights across: the JAX package's Flax ResNet variables → this
package's ResNet ``state_dict``.

The Flax tree ``{"params": ..., "batch_stats": ...}`` arrives as numpy
arrays (``jax.device_get`` / ``np.asarray`` on the caller's side; this
module imports nothing of JAX). Module names are the same on both sides;
only the layouts differ: convolutions HWIO → OIHW, the Dense kernel
(in, out) → Linear weight (out, in), BatchNorm scale/bias/mean/var →
weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ResNet variables (numpy leaves) → state_dict for
    :class:`~.resnet.ResNet` of the same configuration."""
    sd: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            a = np.asarray(leaf, dtype=np.float32)
            mod, name = ".".join(path[:-1]), path[-1]
            if name == "kernel" and a.ndim == 4:  # conv HWIO → OIHW
                sd[f"{mod}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
            elif name == "kernel":  # Dense (in, out) → (out, in)
                sd[f"{mod}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(a.T))
            elif mod == "classifier" and name == "bias":
                sd[f"{mod}.bias"] = torch.from_numpy(a.copy())
            elif name in _BN:
                sd[f"{mod}.{_BN[name]}"] = torch.from_numpy(a.copy())
                bn_modules.add(mod)
            else:
                raise KeyError(f"unexpected variable {'/'.join(path)}")
    for mod in bn_modules:
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
    return sd
