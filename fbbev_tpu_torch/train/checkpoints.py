"""Checkpoints of the full training state.  Counterpart of
``fbbev_tpu/train/checkpoints.py`` (orbax there).

* The whole :class:`~fbbev_tpu_torch.train.trainer.TrainState` -- step,
  params, batch statistics, Adam's moments and count, the EMA copies and
  their update count -- is one plain dict of tensors, ints and floats
  (:func:`state_to_dict`), written with ``torch.save`` and read with
  ``torch.load(..., weights_only=True)``: no pickled class, so any
  PyTorch that defaults to ``weights_only`` loads it.
* One file per step, ``<step>.pt``, written atomically: a temporary file
  in the same directory, then ``os.replace``.  A write cut short leaves
  the temporary file, which :func:`latest_step` ignores, and the previous
  checkpoint as it was.
* The newest ``max_to_keep`` (3, as there) stay; older files are deleted.
* EMA weights live inside the state, so there is no separate EMA file;
  evaluation selects them with ``use_ema``.
* Like the reference, the temporal history is NOT checkpointed: it
  starts empty on a restart.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, List, Optional

import torch

from fbbev_tpu_torch.train.trainer import AdamState, TrainState

_NAME = re.compile(r"^(\d+)\.pt$")
_TENSORS = ("params", "batch_stats", "ema_params", "ema_batch_stats")


def state_to_dict(state: TrainState) -> Dict[str, Any]:
    """The state as a plain dict: tensors, ints and floats only."""
    out = {k: getattr(state, k) for k in _TENSORS}
    out.update(step=int(state.step), ema_updates=float(state.ema_updates),
               opt_state={"count": int(state.opt_state.count),
                          "mu": state.opt_state.mu,
                          "nu": state.opt_state.nu})
    return out


def state_from_dict(d: Dict[str, Any]) -> TrainState:
    opt = d["opt_state"]
    return TrainState(
        step=int(d["step"]), params=d["params"],
        batch_stats=d["batch_stats"],
        opt_state=AdamState(int(opt["count"]), opt["mu"], opt["nu"]),
        ema_params=d["ema_params"], ema_batch_stats=d["ema_batch_stats"],
        ema_updates=float(d["ema_updates"]))


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(ckpt_dir)) if m)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{int(step)}.pt")


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    step: Optional[int] = None,
                    max_to_keep: int = 3) -> str:
    """Write ``state`` as the checkpoint of ``step`` (default: the
    state's), then delete all but the newest ``max_to_keep``.  Returns
    the file's path."""
    step = int(state.step) if step is None else int(step)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    fd, tmp = tempfile.mkstemp(prefix=f".{step}.pt.", suffix=".tmp",
                               dir=ckpt_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(state_to_dict(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.remove(tmp)
        raise
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(checkpoint_path(ckpt_dir, old))
    return path


def restore_checkpoint(ckpt_dir: str, abstract_state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """The checkpoint of ``step`` (default: the latest), on the device of
    ``abstract_state``, whose tensors' shapes and dtypes it must have."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    device = abstract_state.params.device
    d = torch.load(checkpoint_path(ckpt_dir, step), map_location=device,
                   weights_only=True)
    state = state_from_dict(d)
    for name, got, want in (
            [(k, getattr(state, k), getattr(abstract_state, k))
             for k in _TENSORS]
            + [("opt_state.mu", state.opt_state.mu,
                abstract_state.opt_state.mu),
               ("opt_state.nu", state.opt_state.nu,
                abstract_state.opt_state.nu)]):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"checkpoint {step} in {ckpt_dir}: {name} is "
                f"{tuple(got.shape)} {got.dtype}, the model's "
                f"{tuple(want.shape)} {want.dtype}")
    return state


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step saved in ``ckpt_dir``, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None
