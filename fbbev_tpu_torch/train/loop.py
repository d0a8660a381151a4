"""Config-driven model construction of the training / evaluation loops.
Counterpart of ``fbbev_tpu/train/loop.py``, of which only
:func:`build_model` and :func:`_grid_size` are ported so far: the loop
itself (datasets, samplers, checkpoints, evaluation) is ROADMAP M10."""

from __future__ import annotations

from typing import Optional

import torch

from fbbev_tpu_torch.config import Config
from fbbev_tpu_torch.models.builder import build_detector


def build_model(cfg: Config, device="cuda",
                generator: Optional[torch.Generator] = None, **routes):
    """The ``FBOCC`` of ``cfg.model`` (flat or nested schema) on
    ``device``; ``routes`` as :func:`build_detector`'s."""
    model_cfg = (cfg.model.to_dict() if hasattr(cfg.model, "to_dict")
                 else dict(cfg.model))
    return build_detector(model_cfg, device=device, generator=generator,
                          **routes)


def _grid_size(model):
    """(nx, ny, nz) voxels of the model's grid."""
    gc = model.grid_config
    nx = int(round((gc["x"][1] - gc["x"][0]) / gc["x"][2]))
    ny = int(round((gc["y"][1] - gc["y"][0]) / gc["y"][2]))
    nz = int(round((gc["z"][1] - gc["z"][0]) / gc["z"][2]))
    return (nx, ny, nz)
