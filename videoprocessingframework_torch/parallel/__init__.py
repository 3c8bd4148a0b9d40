"""Multi-stream decode and the train and inference steps (single
device)."""

from . import train
from .streams import MultiStreamPipeline, StreamStats
from .train import make_infer_step, make_train_step

__all__ = ["MultiStreamPipeline", "StreamStats", "make_infer_step",
           "make_train_step", "train"]
