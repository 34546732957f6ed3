"""Flow training: data batches, Adam with NaN-skip, the epoch loop, and
the conditional flow's training for the blocked moves."""

from flowstate_tpu_torch.training.blocked import (
    blocked_pairs, make_blocked_train_step, train_blocked,
)
from flowstate_tpu_torch.training.data import (
    dedup_subsample, epoch_batches, flatten_configs, sliding_window_update,
)
from flowstate_tpu_torch.training.train import (
    Adam, AdamState, TrainConfig, TrainState, make_optimizer,
    make_train_step, train, train_epoch,
)

__all__ = [
    "Adam", "AdamState", "TrainConfig", "TrainState", "make_optimizer",
    "make_train_step",
    "train", "train_epoch", "epoch_batches", "flatten_configs", "dedup_subsample",
    "sliding_window_update", "blocked_pairs", "make_blocked_train_step",
    "train_blocked",
]
