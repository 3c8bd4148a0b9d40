"""Single-device train and inference steps for the bundled models — the
counterpart of the JAX package's ``parallel/train.py`` without the mesh.

The JAX step is a pure function of (variables, opt_state, batch); here
the model and a ``torch.optim`` optimizer hold that state and the step
updates them in place. ``torch.optim.SGD(momentum=m)`` and
``torch.optim.Adam`` apply the updates of ``optax.sgd(momentum=m)`` and
``optax.adam``. The step trains the model in training mode: BatchNorm
models normalise by batch statistics and update their running averages
(Flax's ``mutable=["batch_stats"]`` branch); stat-less models (ViT,
VideoViT) compute as in inference. Nothing in the step waits for the
device: the metrics come back as device tensors.

The mesh-sharded parts (parameter sharding rules, placement) wait for
the port of the mesh layer.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import to_device

__all__ = ["make_infer_step", "make_train_step"]


def make_train_step(model: nn.Module,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """``step(batch) -> {"loss", "accuracy"}`` for ``batch = {"image":
    inputs, "label": labels}``.

    Integer labels [B] take softmax cross-entropy with integer targets;
    soft labels [B, classes] (MixUp/CutMix output) take it with
    probability targets, and accuracy compares their argmax. The loss is
    the batch mean, as in the JAX step.
    """

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.train()
        images = batch["image"]
        logits = model(images)
        labels = to_device(batch["label"], logits.device)
        if labels.dim() == 2:
            loss = F.cross_entropy(logits, labels.to(torch.float32))
            hit = logits.argmax(-1) == labels.argmax(-1)
        else:
            labels = labels.long()
            loss = F.cross_entropy(logits, labels)
            hit = logits.argmax(-1) == labels
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(),
                "accuracy": hit.to(torch.float32).mean()}

    return step


def make_infer_step(model: nn.Module) -> Callable:
    """``infer(images) -> logits`` in inference mode, without autograd."""

    def infer(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return model(images)

    return infer
