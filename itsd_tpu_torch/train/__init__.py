from .loop import (OptimizerConfig, TrainState, Tx, create_train_state,
                   make_optimizer, make_train_step)
from .schedule import warmup_cosine_epochs

__all__ = ["OptimizerConfig", "TrainState", "Tx", "create_train_state",
           "make_optimizer", "make_train_step", "warmup_cosine_epochs"]
