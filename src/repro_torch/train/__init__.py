from repro_torch.train.optimizer import AdamWConfig, make_optimizer
from repro_torch.train.step import make_train_step, init_train_state

__all__ = [
    "AdamWConfig",
    "make_optimizer",
    "make_train_step",
    "init_train_state",
]
