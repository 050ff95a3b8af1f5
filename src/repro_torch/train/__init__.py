"""Training: the GSPMD step and the explicit data-parallel step through
the CoRD dataplane, and the gradient sync."""

from repro_torch.train.gradsync import err_state_init, sync_grads
from repro_torch.train.step import (
    TrainState,
    init_state,
    make_explicit_dp_step,
    make_train_step,
    rank_grads,
    state_from_params,
)

__all__ = ["TrainState", "init_state", "make_train_step",
           "make_explicit_dp_step", "rank_grads", "state_from_params",
           "sync_grads",
           "err_state_init"]
