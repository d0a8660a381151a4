"""Warm start: partial loading of pretrained weights into a TrainState.
Counterpart of ``fbbev_tpu/train/pretrained.py``.

The reference trains the flagship from
``load_from='ckpts/r50_256x705_depth_pretrain.pth'`` (occupancy config
``fbocc-r50-cbgs_depth_16f_16x4_20e.py:393``) and supports key-filtered
partial loads ``load_img_from`` (``tools/train.py:277-322``: strip a
``module.`` prefix, keep only ``img_backbone.*`` keys, then
``load_state_dict(strict=False)``).

Two sources:

* a torch ``.pth`` in the reference's names -- the port's own module
  names, so no converter: a ``state_dict`` wrapper and a ``module.``
  prefix are stripped, as mmcv does;
* an ``.npz`` of the JAX package's ``/``-joined variable paths (its
  ``save_params_npz``), relaid out by :mod:`fbbev_tpu_torch.weights`.

The merge checks shapes tensor by tensor and counts what it did under the
JAX package's names (``loaded``, ``shape_mismatch``,
``skipped_by_filter``, ``unused_in_ckpt``, ``missing_in_ckpt``); loading
nothing raises.  The EMA copies are re-seeded from the merged values
(MEGVIIEMAHook snapshots the live model at ``before_run``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from fbbev_tpu_torch.train.trainer import Trainer, TrainState


def _revise(names: Iterable[str], revise_keys):
    """{new name: old name} after the ``(pattern, repl)`` regex pairs."""
    out = {}
    for name in names:
        new = name
        for pat, repl in revise_keys or ():
            new = re.sub(pat, repl, new)
        out[new] = name
    return out


def read_pth(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's tensors by name: a ``state_dict`` wrapper and
    ``module.`` prefixes stripped, BatchNorm ``num_batches_tracked``
    counters (which the port's state does not hold) dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()
            if isinstance(v, torch.Tensor)
            and not k.endswith("num_batches_tracked")}


def read_npz(path: str, model: torch.nn.Module,
             revise_keys=None) -> Tuple[Dict[str, np.ndarray], int]:
    """A JAX ``save_params_npz`` file as the port's tensors of ``model``
    (``revise_keys`` applied to the ``/``-joined JAX paths first), and the
    number of its leaves that map to no tensor of the model."""
    from fbbev_tpu_torch.weights import partial_state_dict
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for new, key in _revise(data.files, revise_keys).items():
            node = tree
            parts = new.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return partial_state_dict(tree, model)


def merge_pretrained(target: Dict[str, torch.Tensor],
                     src: Dict[str, Any],
                     key_filter: Optional[Iterable[str]] = None,
                     revise_keys: Optional[Iterable] = None,
                     log=print) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, int]]:
    """Merge ``src`` (name -> array) into ``target`` (name -> tensor, the
    port's names).

    ``key_filter``: top-level module names to load (``('img_backbone',)``
    for ``load_img_from``).  ``revise_keys``: ``(pattern, repl)`` regex
    pairs applied to the source names.  Returns (merged copy of
    ``target``, stats)."""
    stats = {"loaded": 0, "shape_mismatch": 0, "skipped_by_filter": 0,
             "unused_in_ckpt": 0, "missing_in_ckpt": 0}
    filt = tuple(key_filter) if key_filter else None
    merged = dict(target)
    for name, old in _revise(src, revise_keys).items():
        if name not in target:
            stats["unused_in_ckpt"] += 1
            continue
        if filt is not None and name.split(".")[0] not in filt:
            stats["skipped_by_filter"] += 1
            continue
        tv, sv = target[name], torch.as_tensor(np.asarray(src[old]))
        if tuple(sv.shape) != tuple(tv.shape):
            stats["shape_mismatch"] += 1
            log(f"[load_pretrained] shape mismatch at {name}: ckpt "
                f"{tuple(sv.shape)} vs model {tuple(tv.shape)}")
            continue
        merged[name] = sv.to(tv.dtype)
        stats["loaded"] += 1
    stats["missing_in_ckpt"] = len(target) - stats["loaded"]
    return merged, stats


def load_pretrained(state: TrainState, trainer: Trainer,
                    load_from: Optional[str] = None,
                    load_img_from: Optional[str] = None,
                    revise_keys: Optional[Iterable] = None,
                    log=print) -> TrainState:
    """Apply warm-start file(s) to ``state`` (of ``trainer``'s model).

    ``load_from`` loads everything it can; ``load_img_from`` only the
    image backbone (``img_backbone.*``).  A ``.npz`` is read as JAX
    variables, anything else as a torch checkpoint.  The EMA copies are
    re-seeded from the merged values."""
    target = dict(trainer.unflatten(state.params))
    target.update(trainer.unflatten(state.batch_stats, "batch_stats"))
    for path, key_filter in ((load_from, None),
                             (load_img_from, ("img_backbone",))):
        if not path:
            continue
        if path.endswith(".npz"):
            src, unmapped = read_npz(path, trainer.model, revise_keys)
            target, stats = merge_pretrained(target, src, key_filter,
                                             log=log)
            stats["unused_in_ckpt"] += unmapped
        else:
            target, stats = merge_pretrained(target, read_pth(path),
                                             key_filter, revise_keys, log)
        log(f"[load_pretrained] {path}: {stats}")
        if stats["loaded"] == 0:
            raise ValueError(
                f"warm start from {path} loaded 0 parameters -- "
                "checkpoint/model mismatch")

    def flat(named):
        return torch.cat([target[n].reshape(-1).to(state.params.device,
                                                   torch.float32)
                          for n, _ in named])

    params, batch_stats = flat(trainer.params), flat(trainer.buffers)
    return dataclasses.replace(state, params=params,
                               batch_stats=batch_stats,
                               ema_params=params.clone(),
                               ema_batch_stats=batch_stats.clone())
