"""Training substrate (counterpart of ``repro.train``): step builder, loop,
checkpointing, fault tolerance."""
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import (
    PowerAwareCheckpointer, StragglerMonitor, reassign_shards,
)
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.step import build_train_step

__all__ = [
    "Checkpointer", "PowerAwareCheckpointer", "StragglerMonitor",
    "reassign_shards", "TrainConfig", "train", "build_train_step",
]
