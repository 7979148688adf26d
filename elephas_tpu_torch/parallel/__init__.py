"""Synchronous data-parallel training of the port."""
from .sync_trainer import (SyncAverageTrainer, SyncStepTrainer,
                           build_sharded_evaluate, build_sharded_predict,
                           stack_shards)

__all__ = ["SyncAverageTrainer", "SyncStepTrainer", "build_sharded_predict",
           "build_sharded_evaluate", "stack_shards"]
