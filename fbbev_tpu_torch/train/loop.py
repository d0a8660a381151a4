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

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``.
A config that asks for a mesh (``devices``: the number of ranks, ``"all"``
every rank; ``space``: the camera and BEV row split, see
``fbbev_tpu_torch.parallel``)
runs as one of that many processes (``torchrun``, or a process group
initialised by the caller), each on its own device
(``cuda:{LOCAL_RANK % device_count}``).  ``data.batch_size`` is then the
global batch: each data index reads its own slots of it from the sampler
(``world_size`` = data, ``rank`` = data index; the ``space`` ranks of a
data index read the same ones) and keeps its own temporal state.  Rank 0
alone writes checkpoints and metric sinks; every rank restores.

The kernel routes of ``build_model`` (``pallas3x3=True``, ...), which the
JAX package takes from environment variables, are keyword arguments of
:func:`train` and :func:`evaluate`; no config sets them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from fbbev_tpu_torch import parallel
from fbbev_tpu_torch.config import Config
from fbbev_tpu_torch.data import (
    EvalGroupStreamSampler, InfiniteGroupStreamSampler, SyntheticClipDataset,
    collate)
from fbbev_tpu_torch.evaluation import (
    DetectionMetric, MIoUMetric, occ_pred_to_cvpr_format)
from fbbev_tpu_torch.models.centerpoint_head import (
    NUSCENES_CLASSES, NUSCENES_TASKS, centerpoint_decode)
from fbbev_tpu_torch.models.builder import build_detector, detector_kwargs
from fbbev_tpu_torch.models.fbocc import init_temporal_state
from fbbev_tpu_torch.train.checkpoints import (
    latest_step, restore_checkpoint, save_checkpoint)
from fbbev_tpu_torch.train.trainer import Trainer, make_optimizer

# sample keys only the host-side metrics read in evaluation: never copied
# to the device there (training copies every key)
_HOST_ONLY = ("visible_mask", "gt_attrs", "gt_occupancy",
              "gt_occupancy_cvpr", "gt_depth", "gt_boxes", "gt_labels")


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


def mesh_layout(cfg: Config, world: Optional[int] = None):
    """(data, space) of the mesh ``cfg`` asks for, or None (one device):
    ``devices`` ranks (``"all"`` or unset: ``world``, else the process
    group's or ``torchrun``'s ``WORLD_SIZE``), ``space`` of them
    splitting each sample's cameras and BEV rows.  Raises ``ValueError``
    where ``space`` does not divide the ranks or the model's cameras."""
    devices, space = cfg.get("devices"), int(cfg.get("space") or 1)
    if not devices and space == 1:
        return None
    if devices in (None, "", "all"):
        devices = world or (torch.distributed.get_world_size()
                            if torch.distributed.is_initialized()
                            else int(os.environ.get("WORLD_SIZE", "1")))
    devices = int(devices)
    model_cfg = (cfg.model.to_dict() if hasattr(cfg.model, "to_dict")
                 else dict(cfg.model))
    cams = int(detector_kwargs(model_cfg).get("num_cams", 6))
    if space < 1 or devices % space or cams % space:
        raise ValueError(f"space={space} must divide devices={devices} "
                         f"and the model's {cams} cameras")
    return devices // space, space


def make_train_mesh(cfg: Config, device="cuda"):
    """The ('data', 'space') mesh of :func:`mesh_layout` over the process
    group (initialised from the ``torchrun`` environment if need be), or
    None.  The active mesh when it has that layout."""
    layout = mesh_layout(cfg)
    if layout is None:
        return None
    if not parallel.distributed_init_if_needed(device):
        raise RuntimeError(
            f"devices={cfg.get('devices')!r}, space={cfg.get('space')!r}: "
            "a mesh of N ranks runs as N processes (torchrun "
            "--nproc_per_node N -m fbbev_tpu_torch.tools.train ...)")
    data, space = mesh_layout(cfg, torch.distributed.get_world_size())
    if data * space != torch.distributed.get_world_size():
        raise ValueError(f"devices={data * space}, but the process group "
                         f"has {torch.distributed.get_world_size()} ranks")
    mesh = parallel.active_mesh()
    if mesh is not None and mesh.shape == {"data": data, "space": space}:
        return mesh
    return parallel.make_mesh(data, space, parallel.local_device(device))


def _local_batch_size(cfg: Config, mesh) -> int:
    """This data index's share of the global ``data.batch_size``."""
    batch_size = cfg.data.get("batch_size", 2)
    data = 1 if mesh is None else mesh.data.size
    if batch_size % data:
        raise ValueError(f"data={data} does not divide the global batch "
                         f"of {batch_size}")
    return batch_size // data


def _put_batch(batch: Dict[str, np.ndarray], device, mesh=None
               ) -> Dict[str, torch.Tensor]:
    """This rank's cameras of a host batch, on ``device``."""
    batch = parallel.split_cameras(batch, mesh)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


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
    evaluation every ``eval_interval``.  With a mesh (the module
    docstring) every rank runs this.  Returns ``{"state", "history",
    "trainer", "model", "mesh"}``."""
    mesh = make_train_mesh(cfg, device)
    dev = mesh.device if mesh is not None else torch.device(device)
    lead = mesh is None or mesh.rank == 0
    seed = int(cfg.get("seed", 0))
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(seed),
                        **routes)
    dataset = build_dataset(cfg, "train")
    batch_size = _local_batch_size(cfg, mesh)
    sampler = InfiniteGroupStreamSampler(
        dataset.flag, batch_size,
        world_size=1 if mesh is None else mesh.data.size,
        rank=0 if mesh is None else mesh.data.index, seed=seed)
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
    batch = _put_batch(next(it), dev, mesh)
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
    state = parallel.replicate(state, mesh)

    total = max_iters if max_iters is not None else cfg.get("max_iters")
    temporal_start = cfg.get("temporal_start_iter", 0)
    log_interval = cfg.get("log_interval", 50)
    ckpt_interval = cfg.get("checkpoint_interval", 1000)
    eval_interval = cfg.get("eval_interval")
    sinks = _sinks(cfg, work_dir) if lead else []
    history = []
    t0 = time.perf_counter()
    step0 = int(state.step)
    prev_mismatch = None
    with parallel.use_mesh(mesh):
        for i in range(step0, total):
            state, tstate, metrics = trainer.train_step(
                state, tstate, batch, do_history=i >= temporal_start)
            # the next host batch is made while the device runs the step;
            # the stream/slot contract is checked every iteration on the
            # PREVIOUS step's metrics (finished by then: the batch's copy
            # to the device waits for the step; under a mesh the count is
            # every rank's, so every rank raises alike)
            next_batch = _put_batch(next(it), dev, mesh)
            if prev_mismatch is not None:
                _check_seq_contract(prev_mismatch)
            prev_mismatch = metrics["seq_mismatch"]
            if (i + 1) % log_interval == 0 or i + 1 == total:
                _check_seq_contract(prev_mismatch)
                m = {k: float(v) for k, v in metrics.items()}
                m["iter"] = i + 1
                m["time_per_iter"] = ((time.perf_counter() - t0)
                                      / (i + 1 - step0))
                history.append(m)
                if lead:
                    _emit(m, sinks)
            if (i + 1) % ckpt_interval == 0 or i + 1 == total:
                if lead:
                    save_checkpoint(ckpt_dir, state)
                parallel.barrier(mesh)
            # mid-training streaming eval (the reference runs
            # CustomDistEvalHook every ``eval_interval`` iters during
            # training, occupancy config :359-394): EMA weights, fresh
            # temporal state, full val sweep (or eval_max_samples)
            if eval_interval and (i + 1) % eval_interval == 0 \
                    and i + 1 != total:
                em = evaluate(cfg, state=state, trainer=trainer,
                              max_samples=cfg.get("eval_max_samples"),
                              use_ema=True, work_dir=work_dir, device=device)
                em = {f"val_{k}": v for k, v in em.items()}
                em["iter"] = i + 1
                if lead:
                    _emit(em, sinks)
                history.append(em)
            batch = next_batch
    return {"state": state, "history": history, "trainer": trainer,
            "model": model, "mesh": mesh}


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
    """Streaming evaluation -> with the occupancy head per-class IoU +
    Overall mIoU, with the detection head the nuScenes detection metrics
    (``AP_<class>``, mAP, the TP errors mATE .. mAAE, NDS), and
    ``n_samples``.  Samples without ``gt_boxes`` add nothing to the
    detection metrics.

    Without ``state`` the latest checkpoint under ``<work_dir>/ckpts`` is
    evaluated on a model built from ``cfg`` (``routes`` as
    :func:`build_model`'s); with it, ``trainer``'s model.

    ``tta=True``: the 8 camera-flip x BEV-dx x BEV-dy variants of the
    reference's CustomDistMultiScaleFlipAug3D (``test_time_aug.py:319-392``,
    one variant per rank there) are evaluated as 8 sequential passes here
    (each with fresh temporal state and consistently flipped GT; variants
    merge through the shared confusion matrix and detection metric -- the
    reference never un-flips predictions, its ``aug_test`` is
    unreachable).

    With a mesh every rank runs this: each data index streams its own
    slots (at most ``ceil(max_samples / data)`` samples); under a 'space'
    axis the model gathers its occupancy logits whole on every rank of
    the row split (``FBOCC.forward``), so the 'space' ranks of a data
    index hold the same confusion matrix, and it and ``n_samples`` are
    summed over ``data`` (JAX ``loop.py:345-355``); the detection metric
    stays each rank's own, as there.
    """
    mesh = make_train_mesh(cfg, device)
    dev = mesh.device if mesh is not None else torch.device(device)
    if trainer is None:
        trainer = Trainer(build_model(
            cfg, device=dev,
            generator=torch.Generator().manual_seed(int(cfg.get("seed", 0))),
            **routes))
    model = trainer.model
    dataset = build_dataset(cfg, "val")
    batch_size = _local_batch_size(cfg, mesh)
    data = 1 if mesh is None else mesh.data.size
    if max_samples is not None:
        max_samples = -(-max_samples // data)
    if state is None:
        ckpt_dir = os.path.join(
            work_dir or cfg.get("work_dir", "work_dirs"), "ckpts")
        state = restore_checkpoint(ckpt_dir, trainer.init_state())

    metric = MIoUMetric()
    det_metric = decode_fn = None
    if model.use_detection_head:
        det_metric = DetectionMetric(NUSCENES_CLASSES)
        decode_fn = _make_decode_fn(model)
    n_done = 0
    if tta:
        if not hasattr(dataset, "tta_config"):
            raise ValueError(f"{type(dataset).__name__} has no test-time "
                             "augmentation")
        variants = [dict(tta_flip=bool(v & 4), flip_dx=bool(v & 2),
                         flip_dy=bool(v & 1)) for v in range(8)]
    else:
        variants = [None]
    with parallel.use_mesh(mesh):
        for tta_cfg in variants:
            if tta_cfg is not None:
                dataset.tta_config = tta_cfg
            sampler = EvalGroupStreamSampler(
                dataset.flag, batch_size, world_size=data,
                rank=0 if mesh is None else mesh.data.index)
            tstate = init_temporal_state(
                batch_size, _grid_size(model), model.history_cat_num,
                model.single_bev_num_channels, dtype=model.dtype,
                device=dev)
            n_done += _eval_pass(
                sampler, dataset, trainer, state, tstate, metric, use_ema,
                dev, None if max_samples is None else max_samples - n_done,
                det_metric, decode_fn, mesh)
            if max_samples is not None and n_done >= max_samples:
                break
    if mesh is not None:
        # int64 counts summed over the data indices (the space ranks of
        # one hold the same: the logits are gathered over 'space'), the
        # one collective of the evaluation across data indices
        counts = torch.from_numpy(np.append(metric.hist.ravel(), n_done)
                                  ).to(dev)
        parallel.all_reduce_(counts, mesh.data)
        counts = counts.cpu().numpy()
        metric.hist = counts[:-1].reshape(metric.hist.shape)
        n_done = int(counts[-1])
    results = metric.count_miou() if model.use_occupancy_head else {}
    if det_metric is not None:
        results.update(det_metric.compute())
    results["n_samples"] = n_done
    return results


def _make_decode_fn(model):
    """The model's CenterPoint decode of a whole batch at once
    (``centerpoint_decode``: one sort and one circle-NMS scan for every
    task of every sample), as the JAX package's jitted, batch-vmapped
    ``_make_decode_fn``: det_preds -> (boxes (B, 6K, 9), scores (B, 6K),
    labels (B, 6K))."""
    fp = model.forward_projection
    vs = (float(fp.dx[0]), float(fp.dx[1]))
    pc_range = tuple(model.pc_range)

    def decode(preds):
        return centerpoint_decode(preds, NUSCENES_TASKS, pc_range, vs)

    return decode


def _eval_pass(sampler, dataset, trainer, state, tstate, metric, use_ema,
               device, max_samples, det_metric=None, decode_fn=None,
               mesh=None) -> int:
    """One streaming pass of ``sampler`` into ``metric`` (and, with the
    detection head, ``det_metric`` through ``decode_fn``): the number of
    valid samples evaluated (at most about ``max_samples``)."""
    n_done = 0
    for idxs, valid in sampler:
        samples = [dataset[i] for i in idxs]
        batch = collate(samples)
        tb = _put_batch({k: v for k, v in batch.items()
                         if k not in _HOST_ONLY}, device, mesh)
        outputs, tstate = trainer.eval_step(state, tstate, tb,
                                            use_ema=use_ema)
        # (B, Y, X, Z, classes) float32 logits to the host, where the
        # metric runs
        logits = (outputs["occ_logits"].float().cpu().numpy()
                  if "occ_logits" in outputs else None)
        det = None
        if det_metric is not None and "det_preds" in outputs:
            # the batch's decoded boxes, scores and labels to the host
            det = tuple(a.cpu().numpy()
                        for a in decode_fn(outputs["det_preds"]))
        for b, ok in enumerate(valid):
            if not ok:
                continue
            if logits is not None:
                pred = occ_pred_to_cvpr_format(logits[b])
                gt = np.asarray(samples[b].get(
                    "gt_occupancy_cvpr", samples[b].get("gt_occupancy")))
                metric.add_batch(pred, gt, samples[b].get("visible_mask"))
            if det is not None and "gt_boxes" in samples[b]:
                attrs = samples[b].get("gt_attrs")
                det_metric.add_sample(
                    det[0][b], det[1][b], det[2][b],
                    np.asarray(samples[b]["gt_boxes"]),
                    np.asarray(samples[b]["gt_labels"]),
                    gt_attrs=None if attrs is None else list(attrs))
            n_done += 1
        if max_samples is not None and n_done >= max_samples:
            break
    return n_done
