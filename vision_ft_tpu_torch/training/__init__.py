from .optimizer import get_optimizer
from .scheduler import get_schedule
from .train_step import Microbatches, TrainState, init_train_state, make_eval_step, make_train_step

__all__ = [
    "get_optimizer",
    "get_schedule",
    "Microbatches",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "make_eval_step",
]
