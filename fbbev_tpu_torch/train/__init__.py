"""Training runtime of the port: the train step, optimizer and EMA, the
checkpoints, the warm start and the config-driven loops
(``train.loop``)."""

from fbbev_tpu_torch.train.trainer import TrainState, Trainer, \
    lr_schedule, make_optimizer

__all__ = ["TrainState", "Trainer", "lr_schedule", "make_optimizer"]
