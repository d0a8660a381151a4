"""Config-driven training and evaluation loops.  Counterpart of
``fbbev_tpu/train/loop.py``.

Replaces the reference's mmcv runner stack (``tools/train.py`` ->
``apis/train.py:183-327`` -> IterBasedRunner + hooks) with an explicit
loop: build everything from the config dict, then iterate the
:class:`~fbbev_tpu_torch.train.trainer.Trainer`'s step.

The eval loop reproduces ``CustomDistEvalHook`` semantics
(``models/fbbev/utils/eval_hook.py:57-119``): evaluation uses the EMA
weights, streams scenes contiguously per batch slot, and runs with a
fresh temporal state that is discarded afterwards.

Everything runs on one device, ``cuda`` unless the caller passes
``device="cpu"``; a config that asks for a mesh (``devices``, ``space``)
raises (multi-GPU training is ROADMAP M14).  The kernel routes of
``build_model`` (``pallas3x3=True``, ...), which the JAX package takes
from environment variables, are keyword arguments of :func:`train` and
:func:`evaluate`; no config sets them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from fbbev_tpu_torch.config import Config
from fbbev_tpu_torch.data import (
    EvalGroupStreamSampler, InfiniteGroupStreamSampler, SyntheticClipDataset,
    collate)
from fbbev_tpu_torch.evaluation import MIoUMetric, occ_pred_to_cvpr_format
from fbbev_tpu_torch.models.builder import build_detector
from fbbev_tpu_torch.models.fbocc import init_temporal_state
from fbbev_tpu_torch.train.checkpoints import (
    latest_step, restore_checkpoint, save_checkpoint)
from fbbev_tpu_torch.train.trainer import Trainer, make_optimizer

# sample keys only the host-side metric reads: never copied to the device
_HOST_ONLY = ("visible_mask", "gt_attrs", "gt_occupancy",
              "gt_occupancy_cvpr", "gt_depth")


def build_model(cfg: Config, device="cuda",
                generator: Optional[torch.Generator] = None, **routes):
    """The ``FBOCC`` of ``cfg.model`` (flat or nested schema) on
    ``device``; ``routes`` as :func:`build_detector`'s."""
    model_cfg = (cfg.model.to_dict() if hasattr(cfg.model, "to_dict")
                 else dict(cfg.model))
    return build_detector(model_cfg, device=device, generator=generator,
                          **routes)


def build_dataset(cfg: Config, split: str = "train"):
    d = dict(cfg.data)
    kind = d.pop("type")
    if kind == "SyntheticClipDataset":
        d.pop("batch_size", None)
        d.pop("workers", None)
        return SyntheticClipDataset(**{
            k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})
    if kind == "NuScenesDataset":
        from fbbev_tpu_torch.data import CBGSDataset, NuScenesDataset
        is_train = split == "train"
        ds = NuScenesDataset(
            ann_file=d["ann_file_train" if is_train else "ann_file_val"],
            data_config=d["data_config"],
            bda_aug_conf=d.get("bda_aug_conf"),
            occupancy_path=d.get("occupancy_path"),
            grid_config=d.get("grid_config"),
            is_train=is_train,
            sequences_split_num=d.get(
                "train_sequences_split_num" if is_train
                else "test_sequences_split_num", 1),
            load_depth=is_train,
            cam_names=d.get("cam_names"),
        )
        # class-balanced resampling (reference wraps the train split in
        # CBGSDataset when the config asks for it, datasets/builder.py:49)
        if is_train and d.get("cbgs", False):
            ds = CBGSDataset(ds, seed=int(d.get("cbgs_seed", 0)))
        return ds
    raise KeyError(kind)


def _grid_size(model):
    """(nx, ny, nz) voxels of the model's grid."""
    gc = model.grid_config
    nx = int(round((gc["x"][1] - gc["x"][0]) / gc["x"][2]))
    ny = int(round((gc["y"][1] - gc["y"][0]) / gc["y"][2]))
    nz = int(round((gc["z"][1] - gc["z"][0]) / gc["z"][2]))
    return (nx, ny, nz)


def batch_iterator(dataset, sampler,
                   num_workers: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Sampler-ordered batches; ``num_workers > 0`` decodes ahead of the
    device step on a thread pool (the reference's ``workers_per_gpu``
    dataloader, ``datasets/builder.py:38-109``)."""
    if num_workers > 0:
        from fbbev_tpu_torch.data.loader import PrefetchLoader
        return iter(PrefetchLoader(dataset, sampler,
                                   num_workers=num_workers))
    return (collate([dataset[i] for i in idxs]) for idxs in sampler)


def _single_device(cfg: Config) -> None:
    """Raise for a config that asks for a device mesh."""
    if cfg.get("devices") or int(cfg.get("space") or 1) != 1:
        raise NotImplementedError(
            f"devices={cfg.get('devices')!r}, space={cfg.get('space')!r}: "
            "multi-GPU training and evaluation are ROADMAP M14; the port "
            "runs on one device")


def _put_batch(batch: Dict[str, np.ndarray], device
               ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _sinks(cfg: Config, work_dir: str):
    """The metric sinks (the reference's log_config.hooks): CSV always;
    TensorBoard and a webhook when the config asks."""
    from fbbev_tpu_torch.utils import CsvLogger
    sinks = [CsvLogger(work_dir)]
    if cfg.get("tensorboard"):
        from fbbev_tpu_torch.utils import TensorboardLogger
        sinks.append(TensorboardLogger(work_dir))
    if cfg.get("webhook_url"):
        from fbbev_tpu_torch.utils import WebhookLogger
        sinks.append(WebhookLogger(cfg.get("webhook_url"),
                                   every=cfg.get("webhook_every", 1)))
    return sinks


def _emit(record: Dict[str, Any], sinks) -> None:
    print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                      for k, v in record.items()}), flush=True)
    for sink in sinks:
        sink(record)


def train(cfg: Config, max_iters: Optional[int] = None,
          work_dir: Optional[str] = None, resume: bool = False,
          device="cuda", **routes) -> Dict[str, Any]:
    """Train ``cfg`` for ``max_iters`` (default ``cfg.max_iters``) steps
    on ``device``; ``routes`` reach :func:`build_model`.

    ``resume`` restores the latest checkpoint under ``<work_dir>/ckpts``
    and continues from its step; without it, ``load_from`` /
    ``load_img_from`` warm-start.  Checkpoints every
    ``checkpoint_interval`` steps and at the end, metric records every
    ``log_interval`` (CSV, optionally TensorBoard / webhook), an EMA
    evaluation every ``eval_interval``.  Returns ``{"state", "history",
    "trainer", "model", "mesh": None}``."""
    _single_device(cfg)
    dev = torch.device(device)
    seed = int(cfg.get("seed", 0))
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(seed),
                        **routes)
    dataset = build_dataset(cfg, "train")
    batch_size = cfg.data.get("batch_size", 2)
    sampler = InfiniteGroupStreamSampler(dataset.flag, batch_size,
                                         seed=seed)
    it = batch_iterator(dataset, sampler,
                        num_workers=cfg.data.get("workers", 0))

    # freeze-submodule surface (reference tools/train.py:245-275); a list
    # of top-level module names, e.g. freeze = ('img_backbone',)
    frozen = tuple(cfg.get("freeze", ()) or ())
    trainer = Trainer(
        model,
        optimizer=make_optimizer(frozen=frozen, **dict(cfg.optimizer)),
        ema_base_decay=cfg.ema.get("base_decay", 0.999),
        ema_init_updates=cfg.ema.get("init_updates", 0),
        frozen=frozen)
    tstate = init_temporal_state(
        batch_size, _grid_size(model), model.history_cat_num,
        model.single_bev_num_channels, dtype=model.dtype, device=dev)
    batch = _put_batch(next(it), dev)
    state = trainer.init_state()
    work_dir = work_dir or cfg.get("work_dir", "work_dirs")
    ckpt_dir = os.path.join(work_dir, "ckpts")
    if resume and latest_step(ckpt_dir) is not None:
        state = restore_checkpoint(ckpt_dir, state)
    elif cfg.get("load_from") or cfg.get("load_img_from"):
        from fbbev_tpu_torch.train.pretrained import load_pretrained
        state = load_pretrained(
            state, trainer, cfg.get("load_from"),
            load_img_from=cfg.get("load_img_from"),
            revise_keys=cfg.get("revise_keys"))

    total = max_iters if max_iters is not None else cfg.get("max_iters")
    temporal_start = cfg.get("temporal_start_iter", 0)
    log_interval = cfg.get("log_interval", 50)
    ckpt_interval = cfg.get("checkpoint_interval", 1000)
    eval_interval = cfg.get("eval_interval")
    sinks = _sinks(cfg, work_dir)
    history = []
    t0 = time.perf_counter()
    step0 = int(state.step)
    prev_mismatch = None
    for i in range(step0, total):
        state, tstate, metrics = trainer.train_step(
            state, tstate, batch, do_history=i >= temporal_start)
        # the next host batch is made while the device runs the step; the
        # stream/slot contract is checked every iteration on the PREVIOUS
        # step's metrics (finished by then: the batch's copy to the device
        # waits for the step)
        next_batch = _put_batch(next(it), dev)
        if prev_mismatch is not None:
            _check_seq_contract(prev_mismatch)
        prev_mismatch = metrics["seq_mismatch"]
        if (i + 1) % log_interval == 0 or i + 1 == total:
            _check_seq_contract(prev_mismatch)
            m = {k: float(v) for k, v in metrics.items()}
            m["iter"] = i + 1
            m["time_per_iter"] = (time.perf_counter() - t0) / (i + 1 - step0)
            history.append(m)
            _emit(m, sinks)
        if (i + 1) % ckpt_interval == 0 or i + 1 == total:
            save_checkpoint(ckpt_dir, state)
        # mid-training streaming eval (the reference runs
        # CustomDistEvalHook every ``eval_interval`` iters during
        # training, occupancy config :359-394): EMA weights, fresh
        # temporal state, full val sweep (or eval_max_samples)
        if eval_interval and (i + 1) % eval_interval == 0 \
                and i + 1 != total:
            em = evaluate(cfg, state=state, trainer=trainer,
                          max_samples=cfg.get("eval_max_samples"),
                          use_ema=True, work_dir=work_dir, device=dev)
            em = {f"val_{k}": v for k, v in em.items()}
            em["iter"] = i + 1
            _emit(em, sinks)
            history.append(em)
        batch = next_batch
    return {"state": state, "history": history, "trainer": trainer,
            "model": model, "mesh": None}


def _check_seq_contract(mismatch) -> None:
    """Runtime port of the fuse_history sampler/state assertion
    (``mmdet3d/models/fbbev/detectors/fbocc.py:248``)."""
    if int(mismatch) > 0:
        raise RuntimeError(
            "sampler/state contract violated: a non-start-of-"
            "sequence sample continued a different scene stream "
            "(cf. fbocc.py:248 assertion)")


def evaluate(cfg: Config, state=None, trainer=None,
             max_samples: Optional[int] = None,
             use_ema: bool = True,
             work_dir: Optional[str] = None,
             tta: bool = False, device="cuda", **routes) -> Dict[str, float]:
    """Streaming occupancy evaluation -> per-class IoU + Overall mIoU and
    ``n_samples``.

    Without ``state`` the latest checkpoint under ``<work_dir>/ckpts`` is
    evaluated on a model built from ``cfg`` (``routes`` as
    :func:`build_model`'s); with it, ``trainer``'s model.

    ``tta=True``: the 8 camera-flip x BEV-dx x BEV-dy variants of the
    reference's CustomDistMultiScaleFlipAug3D (``test_time_aug.py:319-392``,
    one variant per rank there) are evaluated as 8 sequential passes here
    (each with fresh temporal state and consistently flipped GT; variants
    merge through the shared confusion matrix -- the reference never
    un-flips predictions, its ``aug_test`` is unreachable).
    """
    _single_device(cfg)
    dev = torch.device(device)
    if trainer is None:
        trainer = Trainer(build_model(
            cfg, device=dev,
            generator=torch.Generator().manual_seed(int(cfg.get("seed", 0))),
            **routes))
    model = trainer.model
    if getattr(model, "use_detection_head", False):
        raise NotImplementedError("detection evaluation is ROADMAP M11")
    dataset = build_dataset(cfg, "val")
    batch_size = cfg.data.get("batch_size", 2)
    if state is None:
        ckpt_dir = os.path.join(
            work_dir or cfg.get("work_dir", "work_dirs"), "ckpts")
        state = restore_checkpoint(ckpt_dir, trainer.init_state())

    metric = MIoUMetric()
    n_done = 0
    if tta:
        if not hasattr(dataset, "tta_config"):
            raise ValueError(f"{type(dataset).__name__} has no test-time "
                             "augmentation")
        variants = [dict(tta_flip=bool(v & 4), flip_dx=bool(v & 2),
                         flip_dy=bool(v & 1)) for v in range(8)]
    else:
        variants = [None]
    for tta_cfg in variants:
        if tta_cfg is not None:
            dataset.tta_config = tta_cfg
        sampler = EvalGroupStreamSampler(dataset.flag, batch_size)
        tstate = init_temporal_state(
            batch_size, _grid_size(model), model.history_cat_num,
            model.single_bev_num_channels, dtype=model.dtype, device=dev)
        n_done += _eval_pass(
            sampler, dataset, trainer, state, tstate, metric, use_ema, dev,
            None if max_samples is None else max_samples - n_done)
        if max_samples is not None and n_done >= max_samples:
            break
    results = metric.count_miou() if model.use_occupancy_head else {}
    results["n_samples"] = n_done
    return results


def _eval_pass(sampler, dataset, trainer, state, tstate, metric, use_ema,
               device, max_samples) -> int:
    """One streaming pass of ``sampler`` into ``metric``: the number of
    valid samples evaluated (at most about ``max_samples``)."""
    n_done = 0
    for idxs, valid in sampler:
        samples = [dataset[i] for i in idxs]
        batch = collate(samples)
        tb = _put_batch({k: v for k, v in batch.items()
                         if k not in _HOST_ONLY}, device)
        outputs, tstate = trainer.eval_step(state, tstate, tb,
                                            use_ema=use_ema)
        # (B, Y, X, Z, classes) float32 logits to the host, where the
        # metric runs
        logits = (outputs["occ_logits"].float().cpu().numpy()
                  if "occ_logits" in outputs else None)
        for b, ok in enumerate(valid):
            if not ok:
                continue
            if logits is not None:
                pred = occ_pred_to_cvpr_format(logits[b])
                gt = np.asarray(samples[b].get(
                    "gt_occupancy_cvpr", samples[b].get("gt_occupancy")))
                metric.add_batch(pred, gt, samples[b].get("visible_mask"))
            n_done += 1
        if max_samples is not None and n_done >= max_samples:
            break
    return n_done
