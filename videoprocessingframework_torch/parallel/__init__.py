"""Train and inference steps (single device)."""

from . import train
from .train import make_infer_step, make_train_step

__all__ = ["make_infer_step", "make_train_step", "train"]
