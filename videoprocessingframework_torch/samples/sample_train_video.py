"""End-to-end video training loop (port of samples/sample_train_video.py):
clip loader → data × tensor parallel train step. Deterministic shuffled
clip sampling, decode + fused pre-processing into ``DTensor`` batches
sharded over the mesh's ``data`` axis, and the step consuming them.
Each clip is labelled by its source file; the plumbing, not the task, is
the point.

    python -m videoprocessingframework_torch.samples.sample_train_video \
        [inputs ...] [--clip-len 4] [--batch 2] [--size 64] [--steps 8] \
        [--checkpoint DIR] [--save-every 2] [--augment] \
        [--model resnet|vit] [--mixup] [--device cpu]

The mesh is a world of one, (1, 1) over ("data", "model"), as the JAX
sample's is on one device. ``--checkpoint`` saves model, optimizer and loader position
every ``--save-every`` steps; a rerun with the same DIR resumes exactly.
On a CUDA device the loader's post-processing is the planar
instantiation of the fused_resize_csc kernel.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ._utils import (
    add_device_arg,
    default_input,
    device_arg,
    get_logger,
    seeded,
    world_mesh,
)

log = get_logger("sample_train_video")


def save(ckdir: pathlib.Path, done: int, model, opt, loader) -> None:
    from ..models import save_checkpoint
    from ..parallel.train import full_state_dict

    save_checkpoint(str(ckdir / "model.pt"),
                    {"model": full_state_dict(model),
                     "opt": opt.state_dict()})
    (ckdir / "meta.json").write_text(json.dumps(
        {"step": done, "loader": loader.state_dict()}))


def restore(ckdir: pathlib.Path, model, opt, loader) -> int:
    """Load a checkpoint :func:`save` wrote; returns its step."""
    from ..models import load_checkpoint

    meta = json.loads((ckdir / "meta.json").read_text())
    state = load_checkpoint(str(ckdir / "model.pt"))
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["opt"])
    loader.load_state_dict(meta["loader"])
    log.info("resumed at step %d (loader %s)", meta["step"], meta["loader"])
    return int(meta["step"])


def _mix(batch, labels, seed: int, num_classes: int):
    """MixUp/CutMix of this rank's shard, re-wrapped as the loader's
    ``DTensor`` placement."""
    from ..ops.augment import mixup_cutmix, sample_mixup_params
    from ..parallel.mesh import Sharding, wrap_local

    x, y = batch.to_local(), labels.to_local()
    params = sample_mixup_params(x.shape[0], np.random.default_rng(seed))
    x, y = mixup_cutmix(x, y, params, num_classes=num_classes)
    sh = Sharding(batch.device_mesh, batch.placements)
    return wrap_local(x, sh), wrap_local(y, sh)


def run(loader, step, steps: int, *, num_classes: int, mixup: bool = False,
        done: int = 0, checkpoint: Optional[Tuple] = None,
        save_every: int = 2) -> Tuple[int, Dict[str, torch.Tensor], float]:
    """Train from step ``done`` up to ``steps`` on ``loader``'s
    ``(batch, labels)`` pairs. ``checkpoint``: ``(dir, model, optimizer)``
    to :func:`save` every ``save_every`` steps. Returns (steps done, the
    last step's metrics, seconds)."""
    t0 = time.perf_counter()
    metrics = {"loss": torch.tensor(float("nan")),
               "accuracy": torch.tensor(float("nan"))}
    while done < steps:
        for batch, labels in loader.epoch():
            if mixup:
                batch, labels = _mix(batch, labels, done, num_classes)
            metrics = step({"image": batch, "label": labels})
            done += 1
            if checkpoint is not None and done % save_every == 0:
                ckdir, model, opt = checkpoint
                save(ckdir, done, model, opt, loader)
            if done >= steps:
                break
        else:  # epoch exhausted without reaching the step budget
            loader.set_epoch(loader.state_dict()["epoch"] + 1)
    metrics = {k: float(v) for k, v in metrics.items()}
    return done, metrics, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="*", default=None)
    ap.add_argument("--clip-len", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="preemption-safe training: save loader + model "
                    "+ optimizer state every --save-every steps; a rerun "
                    "with the same DIR resumes exactly")
    ap.add_argument("--save-every", type=int, default=2)
    ap.add_argument("--augment", action="store_true",
                    help="device-fused crop/flip/jitter augmentation "
                         "(ops/augment.py; deterministic + resume-exact)")
    ap.add_argument("--model", choices=("resnet", "vit"), default="resnet",
                    help="video model family: per-frame ResNet + temporal "
                         "head, or the factorized space-time VideoViT")
    ap.add_argument("--mixup", action="store_true",
                    help="batch-level MixUp/CutMix on device (soft "
                         "targets; ops.augment.mixup_cutmix)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args)
    sources = args.inputs or [default_input()]

    from ..data import AugmentSpec, VideoClipLoader
    from ..parallel.mesh import batch_sharding
    from ..parallel.train import make_train_step

    aug = None
    if args.augment:
        aug = AugmentSpec(crop=True, crop_scale=(0.5, 1.0), hflip=0.5,
                          brightness=0.3, contrast=0.3, saturation=0.3)
        log.info("augment: %s", aug)

    with world_mesh(device, ("data", "model"), (1, 1)) as mesh:
        log.info("mesh: %d device(s) on 'data'", mesh.size())
        loader = VideoClipLoader(
            sources, clip_len=args.clip_len, batch_size=args.batch,
            out_size=(args.size, args.size), output="rgb_f32",
            drop_last=True, sharding=batch_sharding(mesh),
            labels=list(range(len(sources))),  # clip label = source file
            seed=0, augment=aug, device=device)
        nclass = max(2, len(loader.corpus))
        log.info("corpus: %d file(s), %d clips/epoch", len(loader.corpus),
                 loader.clips_per_epoch)

        if args.model == "vit":
            from ..models import video_vit_tiny

            def build():
                return video_vit_tiny(num_classes=nclass,
                                      frames=args.clip_len,
                                      image_size=(args.size, args.size))
        else:
            from ..models import video_resnet18_like

            def build():
                return video_resnet18_like(num_classes=nclass,
                                           frames=args.clip_len)
        model = seeded(build).to(device)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(model, opt, mesh)

        done, ckpt = 0, None
        if args.checkpoint:
            ckdir = pathlib.Path(args.checkpoint)
            ckdir.mkdir(parents=True, exist_ok=True)
            ckpt = (ckdir, model, opt)
            if (ckdir / "meta.json").exists():
                done = restore(ckdir, model, opt, loader)
        done, metrics, dt = run(loader, step, args.steps, num_classes=nclass,
                                mixup=args.mixup, done=done,
                                checkpoint=ckpt, save_every=args.save_every)
    log.info("trained %d steps (batch %dx%d frames) in %.2fs — final loss "
             "%.4f acc %.3f", done, args.batch, args.clip_len, dt,
             metrics["loss"], metrics["accuracy"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
