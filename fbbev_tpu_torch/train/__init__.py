"""Training runtime of the port: the train step, optimizer and EMA."""

from fbbev_tpu_torch.train.trainer import TrainState, Trainer, \
    lr_schedule, make_optimizer

__all__ = ["TrainState", "Trainer", "lr_schedule", "make_optimizer"]
