"""Data-parallel training of the port: the synchronous trainers and the
supervisor of asynchronous workers."""
from .supervisor import QuorumLostError, SupervisorReport, WorkerSupervisor
from .sync_trainer import (SyncAverageTrainer, SyncStepTrainer,
                           build_sharded_evaluate, build_sharded_predict,
                           stack_shards)

__all__ = ["SyncAverageTrainer", "SyncStepTrainer", "build_sharded_predict",
           "build_sharded_evaluate", "stack_shards", "WorkerSupervisor",
           "SupervisorReport", "QuorumLostError"]
