"""repro_torch.train — optimizer, loss, train-step factory (the port of
``repro.train``)."""
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        cosine_schedule, global_norm)
from .step import (TrainState, TrainStepConfig, cross_entropy, make_loss_fn,
                   make_train_step, init_train_state)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "TrainState", "TrainStepConfig",
           "cross_entropy", "make_loss_fn", "make_train_step",
           "init_train_state"]
