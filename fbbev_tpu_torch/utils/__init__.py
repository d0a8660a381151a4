"""Utilities of the port: the inference-time BatchNorm fold, metric sinks
and profiling helpers."""

from fbbev_tpu_torch.utils.logging_hooks import CsvLogger, \
    TensorboardLogger, WebhookLogger
from fbbev_tpu_torch.utils.profiling import flops_estimate, run_time

__all__ = ["CsvLogger", "TensorboardLogger", "WebhookLogger",
           "flops_estimate", "run_time"]
