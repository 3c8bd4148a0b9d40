"""Weights for the bundled models, carried across or loaded.

* :func:`from_jax_variables` — the JAX package's Flax variables → this
  package's ``state_dict`` for the model of the same configuration
  (ResNet, ViT, VideoViT, VideoClassifier, FCN). The Flax tree
  ``{"params": ..., "batch_stats": ...}`` arrives as numpy arrays
  (``jax.device_get`` / ``np.asarray`` on the caller's side; this module
  imports nothing of JAX). Module names are the same on both sides; only
  the layouts differ.
* :func:`load_torch_resnet50` — a torchvision-layout ResNet-50
  ``state_dict`` → this package's :func:`~.resnet.resnet50` names (the
  layouts already agree).
"""

from __future__ import annotations

import re
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
#: the models' raw parameters (Flax ``self.param``), carried as they are
_RAW = ("cls", "pos_embed", "time_pos", "time_cls", "cls_query")


def _kernel(path, a: np.ndarray) -> np.ndarray:
    """A Flax kernel in torch's weight layout."""
    if a.ndim == 4:  # conv HWIO → OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:  # Dense (in, out) → Linear (out, in)
        return a.T
    if a.ndim == 3 and path[-2] == "out":  # (heads, head_dim, dim)
        return a.reshape(-1, a.shape[-1]).T
    if a.ndim == 3:  # query/key/value (dim, heads, head_dim)
        return a.reshape(a.shape[0], -1).T
    raise KeyError(f"unexpected kernel {'/'.join(path)} {a.shape}")


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy leaves) → state_dict for the port's model of
    the same configuration.

    Which leaf is which comes from the tree: a module with running
    statistics in ``batch_stats`` is a BatchNorm (scale/bias/mean/var →
    weight/bias/running_mean/running_var, plus ``num_batches_tracked``);
    a ``kernel`` is a convolution (HWIO → OIHW), a Dense ((in, out) →
    (out, in)) or an attention projection (query/key/value
    (dim, heads, head_dim) and out (heads, head_dim, dim) → Linear
    weights); any other ``scale``/``bias`` is a LayerNorm's or the
    layer's bias (flattened); the raw parameters in ``_RAW`` keep their
    names. Anything else raises ``KeyError``.
    """
    stats = variables.get("batch_stats", {})
    bn_modules = {".".join(p[:-1]) for p, _ in _walk(stats)}
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            a = np.asarray(leaf, dtype=np.float32)
            mod, name = ".".join(path[:-1]), path[-1]
            if mod in bn_modules and name in _BN:
                key = _BN[name]
            elif name == "kernel":
                key, a = "weight", _kernel(path, a)
            elif name == "bias":
                key, a = "bias", a.reshape(-1)
            elif name == "scale":
                key = "weight"
            elif name in _RAW:
                key = name
            else:
                raise KeyError(f"unexpected variable {'/'.join(path)}")
            full = f"{mod}.{key}" if mod else key
            sd[full] = torch.from_numpy(np.array(a, order="C"))
    for mod in bn_modules:
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
    return sd


_TV_HEAD = {"conv1": "stem_conv", "bn1": "stem_bn", "fc": "classifier"}
_TV_PROJ = {"downsample.0": "proj_conv", "downsample.1": "proj_bn"}


def _tv_name(key: str) -> str:
    mod, _, leaf = key.rpartition(".")
    if mod in _TV_HEAD:
        return f"{_TV_HEAD[mod]}.{leaf}"
    m = re.fullmatch(r"layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.[01])",
                     mod)
    if m is None:
        raise KeyError(f"unexpected torchvision key {key!r}")
    i, j, sub = m.groups()
    return f"stage{i}_block{int(j) + 1}.{_TV_PROJ.get(sub, sub)}.{leaf}"


def load_torch_resnet50(state_dict: Mapping[str, object],
                        num_classes: int = 1000) -> Dict[str, torch.Tensor]:
    """torchvision ResNet-50 ``state_dict`` → state_dict for
    :func:`~.resnet.resnet50` (float32; the model casts in its forward).

    Name mapping (torchvision → this package), as the JAX package's
    ``load_torch_resnet50``:
      ``conv1/bn1``             → ``stem_conv`` / ``stem_bn``
      ``layer{i}.{j}.convK/bnK``→ ``stage{i}_block{j+1}.convK/bnK``
      ``layer{i}.{j}.downsample.{0,1}`` → ``proj_conv`` / ``proj_bn``
      ``fc``                    → ``classifier``
    """
    sd: Dict[str, torch.Tensor] = {}
    for key, v in state_dict.items():
        t = (v.detach().cpu() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v)))
        if t.is_floating_point():
            t = t.float()
        sd[_tv_name(key)] = t
    classes = sd["classifier.weight"].shape[0]
    if classes != num_classes:
        raise ValueError(
            f"state_dict has {classes} classes, wanted {num_classes}"
        )
    return sd
