"""Training (the port of ``repro.train``): ``optimizer`` (AdamW), ``step``
(loss, gradients, microbatch accumulation, update), ``loop``
(``run_training``, on one device or a mesh), ``grad`` (explicit
data-parallel gradients, int8 compression) and ``pipeline`` (GPipe)."""
from .optimizer import OptConfig, adamw_update, init_opt_state, schedule
from .step import (abstract_train_state, init_train_state, make_train_step,
                   train_state_axes)

__all__ = ["OptConfig", "adamw_update", "init_opt_state", "schedule",
           "abstract_train_state", "init_train_state", "make_train_step",
           "train_state_axes"]
