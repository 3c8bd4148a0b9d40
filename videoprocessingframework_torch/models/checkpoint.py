"""Model checkpoint save/restore — the counterpart of the JAX package's
orbax-backed ``models/checkpoint.py``.

A checkpoint here is one file written by ``torch.save`` and read back with
``torch.load(weights_only=True)`` (tensors, numbers and containers of
them: a ``state_dict``, an optimizer's ``state_dict``, dicts of those).
Reading the JAX package's orbax directories would need orbax, which this
package does not import; carry Flax variables across with
:func:`~.weights.from_jax_variables` instead.
"""

from __future__ import annotations

import pathlib
from typing import Any, Mapping, Optional

import torch


def save_checkpoint(path: str, state: Any) -> None:
    """Save ``state`` (e.g. ``{"model": m.state_dict(), "opt": …}``) to
    the file ``path``, creating its directory."""
    p = pathlib.Path(path).absolute()
    p.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, p)


def _place(x, like):
    if isinstance(like, torch.Tensor):
        if tuple(x.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape {tuple(x.shape)} != "
                             f"{tuple(like.shape)}")
        return x.to(device=like.device, dtype=like.dtype)
    if isinstance(like, Mapping):
        return {k: _place(x[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_place(a, b) for a, b in zip(x, like))
    return x


def load_checkpoint(path: str, like: Optional[Any] = None) -> Any:
    """Restore what :func:`save_checkpoint` wrote, on the CPU.

    ``like``: optional target of the same structure; each tensor then
    takes the device and dtype of its counterpart in ``like`` (a shape
    that differs raises ``ValueError``).
    """
    p = pathlib.Path(path).absolute()
    state = torch.load(p, map_location="cpu", weights_only=True)
    return state if like is None else _place(state, like)
