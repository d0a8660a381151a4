"""Exponential moving average of params and batch statistics (MEGVII EMA).
Counterpart of ``fbbev_tpu/train/ema.py``: decay
``0.999 * (1 - exp(-updates / 2000))``, evaluation uses the EMA weights."""

from __future__ import annotations

import math

import torch


def megvii_ema_decay(updates: float, base_decay: float = 0.999,
                     tau: float = 2000.0) -> float:
    return base_decay * (1.0 - math.exp(-updates / tau))


def ema_update(ema: torch.Tensor, new: torch.Tensor,
               decay: float) -> torch.Tensor:
    """``ema * decay + new * (1 - decay)``, elementwise, in ema's type."""
    return ema * decay + new.to(ema.dtype) * (1.0 - decay)
