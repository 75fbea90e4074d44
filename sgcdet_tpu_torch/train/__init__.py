"""The train step of the port: optimizer, the single-device and
data-parallel loop, and the view-sharded train and eval steps."""
from .loop import (
    init_train_state,
    make_train_step,
    make_view_sharded_eval_step,
    make_view_sharded_train_step,
)
from .optim import make_optimizer, onecycle_schedule, param_label

__all__ = ["init_train_state", "make_train_step", "make_view_sharded_train_step",
           "make_view_sharded_eval_step", "make_optimizer", "onecycle_schedule",
           "param_label"]
