from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.training.train_step import loss_fn, make_train_step, TrainState

__all__ = ["AdamWState", "adamw_init", "adamw_update", "loss_fn",
           "make_train_step", "TrainState"]
