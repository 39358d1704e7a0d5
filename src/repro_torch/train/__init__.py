"""Training substrate: optimizer, microbatched step, loop, checkpoints,
fault tolerance. `run_with_recovery` and `StragglerWatchdog` are shared
with the serving runtime's recovery layer."""

from .optimizer import OptConfig, adamw_update, init_opt_state, schedule_lr
from .step import make_train_step
from .loop import TrainConfig, build_state, train
from .checkpoint import CheckpointManager
from .fault import (InjectedFailure, StragglerReport, StragglerWatchdog,
                    elastic_remesh, run_with_recovery)

__all__ = ["OptConfig", "adamw_update", "init_opt_state", "schedule_lr",
           "make_train_step", "TrainConfig", "build_state",
           "train", "CheckpointManager", "InjectedFailure", "StragglerReport",
           "StragglerWatchdog", "elastic_remesh", "run_with_recovery"]
