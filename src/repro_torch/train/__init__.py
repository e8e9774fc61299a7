"""Training: the train step, checkpoints and the elastic policy (the port
of ``repro.train``)."""
from . import checkpoint, elastic
from .loop import (TrainState, TrainStep, init_state, make_train_step,
                   value_and_grad)

__all__ = ["TrainState", "TrainStep", "make_train_step", "init_state",
           "value_and_grad", "checkpoint", "elastic"]
