"""repro_torch.train — optimizer, train step, checkpointing, fault-tolerant
loop. The reference's ZeRO-1 specs (``opt_state_pspecs``) and mesh
all-reduce (``compressed_psum``) are TPU-mesh constructs with no
one-device counterpart here."""
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.train.train_step import make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import (SimulatedPreemption, Trainer,
                                       TrainerConfig)

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "make_train_step",
           "CheckpointManager", "Trainer", "TrainerConfig",
           "SimulatedPreemption"]
