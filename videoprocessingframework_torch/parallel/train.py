"""Train and inference steps for the bundled models, on one device or
over a ``data`` × ``model`` mesh — the counterpart of the JAX package's
``parallel/train.py``.

The JAX step is a pure function of (variables, opt_state, batch); here
the model and a ``torch.optim`` optimizer hold that state and the step
updates them in place. ``torch.optim.SGD(momentum=m)`` and
``torch.optim.Adam`` apply the updates of ``optax.sgd(momentum=m)`` and
``optax.adam``. The step trains the model in training mode: BatchNorm
models normalise by batch statistics and update their running averages
(Flax's ``mutable=["batch_stats"]`` branch); stat-less models (ViT,
VideoViT) compute as in inference. Nothing in the step waits for the
device: the metrics come back as device tensors.

Over a mesh (one rank a device, see :mod:`.mesh`), where XLA inserts the
collectives in the JAX package, they are explicit here:

* :func:`shard_variables` keeps, of every ``nn.Conv2d`` / ``nn.Linear``
  weight that :func:`make_param_shardings` shards, this ``model`` rank's
  output rows (and their bias). The layer computes its local output
  channels from a replicated input and gathers them over ``model``
  (Megatron's column split with a gathered output): the input passes
  through :class:`_CopyToModel` (identity; the backward sums the input
  gradient over ``model``) and the output through
  :class:`_GatherFromModel` (all-gather along channels; the backward
  keeps this rank's slice). Everything after a gather computes
  replicated over ``model``. ``torch.distributed.nn.functional.
  all_gather`` is not used: its backward sums every rank's gradient,
  which is tp× too large when the layers after it are replicated.
* Training BatchNorm takes its statistics over the global batch, as
  Flax's does over the sharded batch: the sum, the sum of squares and the
  count are all-reduced over ``data``, with Flax's biased variance
  E[x²] − E[x]², and the backward all-reduces the two sums the
  statistics feed back, so the step takes the global batch's gradient
  (:class:`_GlobalBatchNorm`).
* The loss is the global batch mean: each rank's loss is the mean over
  its local batch and the gradients are averaged over ``data`` by one
  all-reduce of a flat bucket a dtype.

Collectives are issued whatever a group's size, so a world of one goes
through the backend (NCCL on the card) as a larger one does.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.resnet import BatchNorm
from ..utils.device import to_device
from .mesh import batch_sharding, mesh_device, shard_batch, wrap_local

__all__ = ["full_state_dict", "make_infer_step", "make_param_shardings",
           "make_train_step", "shard_variables"]


# ---- collectives with a gradient ---------------------------------------------


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        # one piece: gather in x's own memory order (no relayout)
        order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
        y = x.permute(order).contiguous()
        out = torch.empty_like(y)
        dist.all_gather_into_tensor(out, y, group=group)
        return out.permute([order.index(d) for d in range(x.dim())])
    y = x.movedim(dim, 0).contiguous()
    out = y.new_empty((n * y.shape[0],) + tuple(y.shape[1:]))
    dist.all_gather_into_tensor(out, y, group=group)
    return out.movedim(0, dim)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group
    (each rank's layer saw only its own output channels)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # the layer's fresh input gradient, summed in place (a
        # channels_last gradient is dense as it is)
        if not (grad.is_contiguous() or grad.dim() == 4 and grad.is_contiguous(
                memory_format=torch.channels_last)):
            grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward keeps this rank's
    slice (the layers after the gather compute replicated, so every
    rank's output gradient is already the whole one)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[dim]
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, \
            None


def _float(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least float32 (statistics of bf16 activations)."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the global batch of ``group``, Flax's biased
    statistics, with the global batch's gradient.

    Forward: this rank's mean and biased variance (one ``var_mean``); the
    sum, the sum of squares and the count all-reduced in one call; the
    global mean and E[x²] − E[x]²; one inference-mode ``batch_norm`` with
    them. Backward: every rank's loss reaches every rank's input through
    the statistics, so the two per-channel sums they feed back (Σdy,
    Σdy·x̂) are all-reduced in one call before dx; dγ and dβ are this
    rank's own sums. Returns (y, mean, var); the last two carry no
    gradient (the running averages).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xs = _float(x)
        c = xs.shape[1]
        dims = [0] + list(range(2, xs.dim()))
        var, mean = torch.var_mean(xs, dims, correction=0)
        n = xs.numel() // c
        stats = torch.cat([mean * n, (var + mean * mean) * n,
                           mean.new_full((1,), n)])
        dist.all_reduce(stats, group=group)
        total = stats[2 * c:]
        mean = stats[:c] / total
        var = (stats[c:2 * c] / total - mean * mean).clamp_min(0)
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps), total)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, total = ctx.saved_tensors
        xs, dys = _float(x), _float(dy)
        c = xs.shape[1]
        dims = [0] + list(range(2, xs.dim()))
        shape = (1, c) + (1,) * (xs.dim() - 2)
        xhat = (xs - mean.view(shape)) * invstd.view(shape)
        mine = torch.cat([dys.sum(dims), (dys * xhat).sum(dims)])
        sums = mine.clone()
        dist.all_reduce(sums, group=ctx.group)
        sums /= total
        dx = (dys - sums[:c].view(shape) - xhat * sums[c:].view(shape)) \
            * (weight * invstd).view(shape)
        return (dx.to(x.dtype), mine[c:].to(weight.dtype),
                mine[:c].to(weight.dtype), None, None)


# ---- the sharding rule and the placement ---------------------------------------


def _param_spec(name: str, param: torch.Tensor) -> Optional[int]:
    """The dim to shard over ``model``, or None to replicate.

    Convolution weights (cout, cin, kh, kw) and Linear weights (out, in)
    shard their output rows (dim 0) — the dim Flax's ``kernel`` keeps
    last. Everything else (biases, norms, embeddings) replicates.
    """
    if name.rsplit(".", 1)[-1] == "weight" and param.dim() in (2, 4):
        return 0
    return None


def _model_size(mesh: DeviceMesh) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index("model")) if "model" in names else 1


def make_param_shardings(mesh: DeviceMesh, model: nn.Module) -> Dict:
    """``{parameter name: placements}`` (one a mesh axis). A weight the
    rule shards whose output rows do not divide by the ``model`` axis, or
    number fewer than twice it, stays replicated."""
    names = mesh.mesh_dim_names or ()
    tp = _model_size(mesh)
    out = {}
    for name, p in model.named_parameters():
        dim = _param_spec(name, p)
        if dim is not None and (p.shape[dim] % tp or p.shape[dim] < 2 * tp
                                or "model" not in names):
            dim = None
        out[name] = tuple(Shard(dim) if a == "model" and dim is not None
                          else Replicate() for a in names)
    return out


def _sharded(placements) -> bool:
    return any(isinstance(p, Shard) for p in placements)


def _broadcast(tensors, src: int = 0) -> None:
    """Rank ``src``'s values into ``tensors`` on every rank: one
    broadcast a dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src)
        k = 0
        for t in ts:
            t.copy_(flat[k:k + t.numel()].view(t.shape))
            k += t.numel()


def _batch_norm_over(bn: BatchNorm, group, x: torch.Tensor) -> torch.Tensor:
    """:class:`~..models.resnet.BatchNorm`'s forward with training
    statistics over the global batch (the ranks of ``group``)."""
    if not bn.training:
        return BatchNorm.forward(bn, x)
    y, mean, var = _GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn.eps,
                                          group)
    with torch.no_grad():
        w = 1 - bn.MOMENTUM  # Flax: m · running + (1 − m) · batch
        bn.running_mean.lerp_(mean.to(bn.running_mean.dtype), w)
        bn.running_var.lerp_(var.to(bn.running_var.dtype), w)
        bn.num_batches_tracked.add_(1)
    return y.to(bn.compute_dtype)


def shard_variables(mesh: DeviceMesh, model: nn.Module) -> nn.Module:
    """Place ``model`` on the mesh, in place, and return it.

    Rank 0's parameters and buffers are broadcast (a replicated value is
    the same on every rank, as ``jax.device_put`` of one host value).
    Each weight :func:`make_param_shardings` shards keeps this ``model``
    rank's output rows, its bias the same rows, and its layer gathers its
    output over ``model``; everything else, the BatchNorm buffers
    included, stays whole on every rank. The package's BatchNorm takes
    its training statistics over ``data``. Parameters keep their
    identity, so an optimizer built before stays bound to them.
    """
    names = mesh.mesh_dim_names or ()
    if "data" not in names:
        raise ValueError(f"mesh axes {names} have no 'data' axis")
    model.to(mesh_device(mesh))
    with torch.no_grad():
        _broadcast(list(model.parameters()) + list(model.buffers()))
    specs = make_param_shardings(mesh, model)
    data = mesh.get_group("data")
    if "model" in names:
        group, r = mesh.get_group("model"), mesh.get_local_rank("model")
        tp = _model_size(mesh)
    split = set()  # state names that hold this rank's rows only
    for mod_name, m in model.named_modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            if not isinstance(m, BatchNorm):
                raise TypeError(f"{mod_name}: only the package's BatchNorm "
                                "takes statistics over the mesh")
            m.forward = partial(_batch_norm_over, m, data)
            continue
        if not isinstance(m, (nn.Conv2d, nn.Linear)):
            continue
        key = f"{mod_name}.weight" if mod_name else "weight"
        if not _sharded(specs[key]):
            continue
        rows = m.weight.shape[0] // tp
        with torch.no_grad():
            for pname in ("weight", "bias"):
                p = getattr(m, pname)
                if p is not None:
                    p.data = p.data[r * rows:(r + 1) * rows].clone()
                    split.add(f"{mod_name}.{pname}" if mod_name else pname)
        if isinstance(m, nn.Conv2d):
            m.out_channels, dim = rows, 1
        else:
            m.out_features, dim = rows, -1
        m.register_forward_pre_hook(
            lambda mod, args, g=group: (_CopyToModel.apply(args[0], g),)
            + tuple(args[1:]))
        m.register_forward_hook(
            lambda mod, args, out, g=group, d=dim: _GatherFromModel.apply(
                out, d % out.dim(), g))
    model._vpf_mesh = mesh
    model._vpf_split = split
    return model


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` of a model :func:`shard_variables` placed:
    sharded rows gathered over ``model`` (every rank gets all of it)."""
    split = getattr(model, "_vpf_split", None)
    if split is None:
        raise ValueError("the model is not placed on a mesh")
    out = {}
    for k, v in model.state_dict().items():
        if k in split:
            v = _all_gather(v.contiguous(), 0,
                            model._vpf_mesh.get_group("model"))
        out[k] = v
    return out


# ---- the steps -------------------------------------------------------------------


def _local(x, mesh: DeviceMesh):
    """A batch's rank-local part: a DTensor's local shard, else the
    global host batch sharded over ``data``."""
    if not isinstance(x, DTensor):
        x = shard_batch(x, mesh)
    return x.to_local()


def _loss_and_hits(logits: torch.Tensor, labels: torch.Tensor):
    """Softmax cross-entropy (batch mean) and the hit mask; integer labels
    [B] or soft labels [B, classes] (MixUp/CutMix output)."""
    if labels.dim() == 2:
        loss = F.cross_entropy(logits, labels.to(torch.float32))
        hit = logits.argmax(-1) == labels.argmax(-1)
    else:
        labels = labels.long()
        loss = F.cross_entropy(logits, labels)
        hit = logits.argmax(-1) == labels
    return loss, hit


def _average_grads(params, group, n: int) -> None:
    """Average the gradients over ``group``: one all-reduce of one flat
    bucket a dtype."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        torch._foreach_copy_(gs, [f.view(g.shape) for f, g in zip(
            flat.split([g.numel() for g in gs]), gs)])


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    mesh: Optional[DeviceMesh] = None) -> Callable:
    """``step(batch) -> {"loss", "accuracy"}`` for ``batch = {"image":
    inputs, "label": labels}``.

    Integer labels [B] take softmax cross-entropy with integer targets;
    soft labels [B, classes] (MixUp/CutMix output) take it with
    probability targets, and accuracy compares their argmax. The loss is
    the batch mean, as in the JAX step.

    With ``mesh`` the step is data × tensor parallel: the model is placed
    by :func:`shard_variables` (here, unless it already is), ``image``
    and ``label`` are ``DTensor``s sharded on dim 0 (a sharded loader's
    batches) or global host batches, which are sharded here, the loss and
    accuracy are the global batch's, and the gradients are averaged over
    ``data`` before the optimizer steps.
    """
    if mesh is None:
        def step(batch: Dict) -> Dict[str, torch.Tensor]:
            model.train()
            logits = model(batch["image"])
            labels = to_device(batch["label"], logits.device)
            loss, hit = _loss_and_hits(logits, labels)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            return {"loss": loss.detach(),
                    "accuracy": hit.to(torch.float32).mean()}

        return step

    if getattr(model, "_vpf_mesh", None) is not mesh:
        shard_variables(mesh, model)
    data = mesh.get_group("data")
    dp = dist.get_world_size(data)
    params = list(model.parameters())

    def sharded_step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.train()
        logits = model(_local(batch["image"], mesh))
        labels = _local(batch["label"], mesh).to(logits.device)
        loss, hit = _loss_and_hits(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _average_grads(params, data, dp)
        optimizer.step()
        metrics = torch.stack([loss.detach().float(),
                               hit.to(torch.float32).mean()])
        dist.all_reduce(metrics, group=data)
        metrics /= dp
        return {"loss": metrics[0], "accuracy": metrics[1]}

    return sharded_step


def make_infer_step(model: nn.Module,
                    mesh: Optional[DeviceMesh] = None) -> Callable:
    """``infer(images) -> logits`` in inference mode, without autograd.

    With ``mesh``: data-parallel over ``data`` (the model placed by
    :func:`shard_variables` unless it already is); ``images`` is a
    ``DTensor`` sharded on dim 0 or a global host batch, and the logits
    come back as a ``DTensor`` sharded on dim 0. ``infer.batch_multiple``
    is the ``data`` size, which a batch must be a multiple of."""
    if mesh is None:
        def infer(images: torch.Tensor) -> torch.Tensor:
            model.eval()
            with torch.no_grad():
                return model(images)

        infer.batch_multiple = 1
        return infer

    if getattr(model, "_vpf_mesh", None) is not mesh:
        shard_variables(mesh, model)
    sharding = batch_sharding(mesh)

    def sharded_infer(images):
        model.eval()
        with torch.no_grad():
            return wrap_local(model(_local(images, mesh)), sharding)

    sharded_infer.batch_multiple = sharding.batch_ranks
    return sharded_infer
