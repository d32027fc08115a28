from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    constant_schedule,
    cosine_schedule,
)
from repro_torch.training.train_loop import (
    init_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
    opt_state_specs,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "constant_schedule",
    "cosine_schedule", "init_train_state", "make_eval_step", "make_loss_fn",
    "make_train_step", "opt_state_specs",
]
