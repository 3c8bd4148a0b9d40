"""The parallel layer: multi-stream decode, the mesh (one rank a device
over ``torch.distributed``), sharded and multi-device video pipelines,
and the train and inference steps (single device or data × tensor
parallel)."""

from . import train
from .mesh import batch_sharding, device_round_robin, make_mesh, shard_batch
from .multidevice import MultiDeviceStreamPipeline, ShardedVideoPipeline
from .multihost import GlobalBatchAssembler, MultiHostVideoPipeline
from .streams import MultiStreamPipeline, StreamStats
from .train import make_infer_step, make_train_step

__all__ = ["GlobalBatchAssembler", "MultiDeviceStreamPipeline",
           "MultiHostVideoPipeline", "MultiStreamPipeline",
           "ShardedVideoPipeline", "StreamStats", "batch_sharding",
           "device_round_robin", "make_infer_step", "make_mesh",
           "make_train_step", "shard_batch", "train"]
