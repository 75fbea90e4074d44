"""The train step of the port: optimizer and single-device loop."""
from .loop import init_train_state, make_train_step
from .optim import make_optimizer, onecycle_schedule, param_label

__all__ = ["init_train_state", "make_train_step", "make_optimizer",
           "onecycle_schedule", "param_label"]
