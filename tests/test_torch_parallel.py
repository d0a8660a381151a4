"""The port's multi-rank training and evaluation (``fbbev_tpu_torch.parallel``)
on the CPU over gloo, against its own one-process step on the global batch
and against the JAX package's mesh pieces.

One module-scoped fixture spawns ONE set of three processes (one for the
whole test run under xdist, see ``runs``): the children run this file as
a script, set one thread each, import only the port (numpy, torch,
``fbbev_tpu_torch``: everything JAX is imported inside the tests), run
every multi-rank case and write their results.  They join first as a
three-rank gloo group for the ``space=3`` cases; then ranks 0 and 1 form
a two-rank group of their own for the two-rank layouts while rank 2
makes their one-process references.  Each group joins through a
``file://`` store in a temporary directory (no TCP port, so xdist
workers cannot collide).  A child that has not finished after
``TIMEOUT`` seconds is killed and every test of the file fails.  The
tests compare those results with one-process runs made here.

The steps run a micro FB-OCC (ResNet-10, 32x96 images, 2 cameras, a
20x20x4 grid), in float32 with the configs' optimizer and in float64
(``float64``, ``test_torch_train``'s patch) with its warmup off, so that
the first update moves every parameter by about 2e-4.  ``data=2`` holds
one sample a rank of a global batch of 2 and is compared with the
one-process step on both samples with the occupancy losses per sample
and meaned (``Trainer(loss_shards=2)``, JAX's ``_occ_losses_sharded``);
``space=2`` holds one camera a rank of a one-sample batch and splits the
BEV rows (levels of 5, 10, 20 and 40 rows: 3/2, 6/4, 12/8, 24/16), over
two frames -- a stream start, then a frame under a non-identity ego
motion, so the second step warps the history -- compared with the
one-process steps on both cameras.  The train and
evaluation loops (``space=2`` through the two tools) build their mesh
from the group, as under ``torchrun``.  ``space=3`` runs the micro
model's BEV stages (encoder, FPN3D, occ head and loss; 2/2/1 coarse
rows: the middle rank has two neighbours) and its detection head (on the
gathered finest level, with the trainer's loss shares) forward and
backward.  The
one-process tests at the end check the row plan, the halo widths, the
split convs, the split upsample and K8 / K9 under the split with no
group (the ranks simulated by threads).

Tolerances:

* float64: the gradient within 1e-10 of its largest magnitude (measured
  5e-14), every parameter, statistic and EMA element within rtol 1e-5,
  atol 1e-6, each metric within 1e-10 relative: the invariant that after
  the one sum over the world every rank holds the one-process step's
  gradient, with float32 rounding out of the way; the three-rank BEV
  stages' and detection head's outputs, loss, gradients and statistics
  1e-10 of their largest magnitude;
* float32: parameters and EMA within rtol 1e-5, atol 1e-6; the BatchNorm
  running statistics (of order 1: the variances start at 1) rtol 1e-5,
  atol 2e-5 (measured 6.7e-6: the global statistics come from a two-pass
  reduction in another order than ``F.batch_norm``'s, and the
  differences grow with depth, as ``test_torch_train`` measures); the
  gradient within 1e-3 of its largest magnitude (measured 2.0e-4:
  behind every batch-statistics BatchNorm of a random-weight model the
  gradient sums nearly cancel); each metric but ``grad_norm`` 1e-4
  relative (``test_torch_train``'s);
* the carried history (``space=2``) within 1e-10 (float64, measured 0)
  or 1e-4 (float32, measured 2.1e-5: the two cameras' partial pools
  summed in another order) of its largest magnitude;
* the pooled BEV of ``space=2`` against JAX's ``_pool`` under
  ``use_mesh(make_mesh(data=1, space=2))``: 1e-5 of its largest value;
* the per-shard loss reduction against JAX's: 1e-5 relative;
* the synchronised BatchNorm on unequal local sizes against
  ``F.batch_norm`` on their concatenation, float64: 1e-12;
* the split upsample against ``F.interpolate``, float32: 1e-6;
* K8 / K9 under the split against the head on the whole grid, float64:
  the labels equal, the logits within 1e-10 of their largest magnitude;
* evaluation: the confusion matrices equal, element for element; the
  ``space=2`` logits within 1e-5 of their largest magnitude (measured
  3.8e-7).
"""

import atexit
import contextlib
import copy
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fbbev_tpu_torch import parallel
from fbbev_tpu_torch.config import Config
from fbbev_tpu_torch.models import layers
from fbbev_tpu_torch.models import FBOCC
from fbbev_tpu_torch.models.fbocc import init_temporal_state
from fbbev_tpu_torch.train import Trainer, make_optimizer
from fbbev_tpu_torch.train import checkpoints as CK
from fbbev_tpu_torch.train import loop as PL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
WORLD = 3      # the group's ranks
PAIR = (0, 1)  # the ranks of the two-rank layouts
GRID = {"x": (-40.0, 40.0, 4.0), "y": (-40.0, 40.0, 4.0),
        "z": (-1.0, 5.4, 1.6), "depth": (2.0, 42.0, 2.0)}
MICRO = dict(grid_config=GRID,
             bevformer_grid_config={k: GRID[k] for k in "xyz"},
             input_size=(32, 96), num_cams=2, history_cat_num=2,
             single_bev_num_channels=32, depth_channels=20,
             backbone_depth=10, img_feat_channels=64, depth_mid_channels=32,
             max_queries_per_cam=128, history_cat_conv_out_channels=64,
             voxel_channels=(8, 16, 32), voxel_out_channels=16)
LAYOUTS = {"data2": (2, 1), "space2": (1, 2)}
# the loop cases: the tiny synthetic config cut to the micro model, on
# two 2-frame scenes; the global batch holds one sample a data index
LOOP_CUT = {**{f"model.{k}": repr(v) for k, v in MICRO.items()},
            "data.input_size": "(32, 96)", "data.occ_shape": "(40, 40, 8)",
            "data.n_scenes": "2", "data.frames_per_scene": "2",
            "log_interval": "1", "checkpoint_interval": "100"}
LOOP_OPTS = {"data2": {"devices": "2", "data.batch_size": "2"},
             "space2": {"space": "2", "data.batch_size": "1"}}


# ---------------------------------------------------------------------------
# Shared by the children and the tests: torch and numpy only.
# ---------------------------------------------------------------------------

def rig(B, N=2, H=32, W=96, f=40.0):
    """N horizontal cameras around the ego at 1.5 m, (B, N, ...) numpy."""
    rots, trans, intr = [], [], []
    for n in range(N):
        th = 2 * np.pi * n / N
        fwd = [np.cos(th), np.sin(th), 0.0]
        right = [np.sin(th), -np.cos(th), 0.0]
        rots.append(np.stack([right, [0.0, 0.0, -1.0], fwd], 1))
        trans.append([0.1 * n + 0.0137, 0.05 * n + 0.0137, 1.5137])
        intr.append([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    rep = (lambda a: np.repeat(np.asarray(a, np.float32)[None], B, 0))
    return dict(rots=rep(rots), trans=rep(trans), intrins=rep(intr),
                post_rots=rep(np.tile(np.eye(3), (N, 1, 1))),
                post_trans=np.zeros((B, N, 3), np.float32),
                bda=rep(np.eye(3)))


def micro_batch(B, seed=0):
    """numpy batch of ``B`` stream starts for the micro model."""
    rng = np.random.RandomState(seed)
    occ = rng.randint(0, 19, size=(B, 40, 40, 8))
    occ = np.where(rng.rand(B, 40, 40, 8) < 0.3, 255, occ)
    depth = rng.rand(B, 2, 32, 96).astype(np.float32) * 45.0
    depth = np.where(rng.rand(B, 2, 32, 96) < 0.8, 0.0, depth)
    return dict(imgs=rng.randn(B, 2, 32, 96, 3).astype(np.float32),
                **rig(B), start_of_sequence=np.ones(B, bool),
                sequence_group_idx=np.arange(B, dtype=np.int32),
                curr_to_prev_ego_rt=np.repeat(np.eye(4, dtype=np.float32)
                                              [None], B, 0),
                gt_occupancy=occ.astype(np.int32),
                gt_depth=depth.astype(np.float32))


def pool_inputs(seed=1):
    """(cam, context (1, 2, 2, 6, 32), depth (1, 2, 20, 2, 6)) numpy."""
    rng = np.random.RandomState(seed)
    d = rng.rand(1, 2, 20, 2, 6).astype(np.float32)
    return (rig(1), rng.randn(1, 2, 2, 6, 32).astype(np.float32),
            d / d.sum(2, keepdims=True))


def loss_inputs(seed=3):
    """Fixed occupancy logits (2, 8, 8, 4, 19) and labels."""
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 8, 8, 4, 19).astype(np.float32),
            rng.randint(0, 19, size=(2, 8, 8, 4)).astype(np.int32))


@contextlib.contextmanager
def float64():
    """The port in float64 (``test_torch_train._float64``'s patch):
    ``Tensor.float`` casts to float64, new floating tensors and float32
    numpy arrays come in as float64."""
    own = torch.Tensor.__dict__.get("float")
    real_from_numpy, old = torch.from_numpy, torch.get_default_dtype()
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.from_numpy = (lambda a: real_from_numpy(a).double()
                        if a.dtype == np.float32 else real_from_numpy(a))
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        if own is None:
            del torch.Tensor.float
        else:
            torch.Tensor.float = own
        torch.from_numpy = real_from_numpy
        torch.set_default_dtype(old)


def micro_trainer(f64=False):
    """(Trainer of the micro model, its initial state, the list its
    optimizer appends each step's gradient to); the same weights in every
    process.  float32: the configs' optimizer (its first step's learning
    rate is 2e-7); float64: warmup off, every parameter moves by ~2e-4."""
    with float64() if f64 else contextlib.nullcontext():
        model = FBOCC(**MICRO, device="cpu",
                      dtype=torch.float64 if f64 else torch.float32,
                      generator=torch.Generator().manual_seed(0))
        tr = Trainer(model, optimizer=make_optimizer(
            warmup_iters=0 if f64 else 200), lovasz="sort")
        seen = []
        real = tr.optimizer.update
        tr.optimizer.update = (lambda g, *a, **k: (seen.append(g.clone()),
                                                   real(g, *a, **k))[1])
        return tr, tr.init_state(), seen


def det_boxes(seed=4):
    """``gt_boxes`` (1, 12, 9) and ``gt_labels`` (1, 12) of one sample:
    a box of each of the ten classes on the grid, two of padding."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((1, 12, 9), np.float32)
    boxes[0, :10, :2] = rng.uniform(-35.0, 35.0, (10, 2))
    boxes[0, :10, 2] = rng.uniform(-0.5, 1.5, 10)
    boxes[0, :10, 3:6] = rng.uniform(1.0, 4.0, (10, 3))
    boxes[0, :10, 6] = rng.uniform(-np.pi, np.pi, 10)
    boxes[0, :10, 7:9] = rng.uniform(-2.0, 2.0, (10, 2))
    labels = np.full((1, 12), -1, np.int64)
    labels[0, :10] = np.arange(10)
    return dict(gt_boxes=boxes, gt_labels=labels)


def two_frames(seed=0):
    """numpy batches of two frames of one stream: a start, then the next
    frame under a non-identity ego motion (7 degrees of yaw, 3.1 m and
    -1.7 m), so the second step warps the carried history."""
    first, second = micro_batch(1, seed), micro_batch(1, seed + 1)
    second["start_of_sequence"] = np.zeros(1, bool)
    second["sequence_group_idx"] = first["sequence_group_idx"]
    c, s = np.cos(np.deg2rad(7.0)), np.sin(np.deg2rad(7.0))
    rt = np.eye(4, dtype=np.float32)
    rt[:2, :2] = [[c, -s], [s, c]]
    rt[:3, 3] = [3.1, -1.7, 0.0]
    second["curr_to_prev_ego_rt"] = rt[None]
    return [first, second]


def micro_step(trainer, batch, mesh=None, loss_shards=1, f64=False):
    """Train steps of ``micro_trainer(f64)``'s (trainer, initial state,
    gradients) on the numpy ``batch`` (a list: frames one after another,
    the temporal state carried; every step from the initial state, so
    that the first update's learning rate bounds each float32 update)
    under ``mesh``: the last step's new state and metrics, each step's
    gradient (stacked) and the carried history as numpy."""
    tr, s0, seen = trainer
    frames = batch if isinstance(batch, list) else [batch]
    with float64() if f64 else contextlib.nullcontext():
        tr.loss_shards = loss_shards
        ts = init_temporal_state(frames[0]["imgs"].shape[0], (20, 20, 4), 2,
                                 32, dtype=tr.model.dtype, device="cpu")
        seen.clear()
        with parallel.use_mesh(mesh):
            for f in frames:
                st, ts, m = tr.train_step(
                    s0, ts, {k: torch.from_numpy(v) for k, v in f.items()})
    return dict(params=st.params.numpy(), batch_stats=st.batch_stats.numpy(),
                ema_params=st.ema_params.numpy(),
                ema_batch_stats=st.ema_batch_stats.numpy(),
                grads=np.stack([g.numpy() for g in seen]),
                history=ts.history_bev.float().numpy(),
                metrics={k: float(v) for k, v in m.items()})


STATE = ("params", "batch_stats", "ema_params", "ema_batch_stats")


def step_errors(got, want, f64, history=False):
    """The figures the step tests hold (a child holds both steps' arrays;
    only these reach the tests), each <= 1 where within its tolerance
    (module docstring): per state tensor and per metric the largest error
    over its tolerance, the gradient's (the largest over the steps) and,
    with ``history``, the carried history's largest error over its
    largest magnitude."""
    g, w = got["grads"], want["grads"]
    out = dict(grad=max(float(np.abs(a - b).max() / np.abs(b).max())
                        for a, b in zip(g, w)) / (1e-10 if f64 else 1e-3))
    if history:
        h, v = got["history"], want["history"]
        out["history"] = float(np.abs(h - v).max() / np.abs(v).max()
                               / (1e-10 if f64 else 1e-4))
    for k in STATE:
        atol = 1e-6 if f64 or "params" in k else 2e-5
        out[k] = float((np.abs(got[k] - want[k])
                        / (atol + 1e-5 * np.abs(want[k]))).max())
    rtol = 1e-10 if f64 else 1e-4
    out["metrics"] = {k: abs(got["metrics"][k] - v) / (1e-6 + rtol * abs(v))
                      for k, v in want["metrics"].items() if k != "grad_norm"}
    return out


def step_digest(got, history=False):
    """Digests of the state and gradients (and of the carried history,
    which the 'space' ranks of a sample hold alike)."""
    return {k: hashlib.sha256(got[k].tobytes()).hexdigest()
            for k in STATE + ("grads",) + ("history",) * history}


def bev_stages():
    """The micro model's BEV stages in float64 (3D encoder, FPN3D, occ
    head), a fixed input of the cat conv's channels (1, 64, 20, 20, 4)
    and labels (1, 40, 40, 8)."""
    with float64():
        model = FBOCC(**MICRO, device="cpu", dtype=torch.float64,
                      generator=torch.Generator().manual_seed(2))
    rng = np.random.RandomState(5)
    gt = rng.randint(0, 19, size=(1, 40, 40, 8))
    gt = np.where(rng.rand(1, 40, 40, 8) < 0.3, 255, gt)
    return model, rng.randn(1, 64, 20, 20, 4), gt


def bev_run(model, x, gt, split=None):
    """One train-mode forward and backward of :func:`bev_stages` on x
    (this rank's rows under ``split``, the loss a 1 / ranks share of the
    gathered logits'): {the gathered logits, the loss, the stages'
    parameter gradients and the input gradient summed over the split's
    ranks, the BatchNorm running statistics}, numpy."""
    from fbbev_tpu_torch.models import losses as loss_lib
    from fbbev_tpu_torch.models.occ_head import occ_losses
    model = copy.deepcopy(model)  # the running statistics move
    stages = (model.img_bev_encoder_backbone, model.img_bev_encoder_neck,
              model.occupancy_head)
    for m in stages:
        m.train()
    S = 1 if split is None else split.axis.size
    with float64():
        xt = torch.tensor(x, requires_grad=True)
        xr = xt if split is None else split.take(xt, 2)
        logits = model.occupancy_head(model.img_bev_encoder_neck(
            model.img_bev_encoder_backbone(xr)), return_labels=False,
            split=split)
        if split is not None:
            logits = split.gather(logits, 1)
        loss = sum(occ_losses(
            logits, torch.from_numpy(gt),
            torch.from_numpy(loss_lib.occ_class_weights(19)),
            torch.from_numpy(loss_lib.bev_distance_weight(40, 40)),
            lovasz="sort").values()) / S
        model.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for m in stages for p in m.parameters()]
        flat = torch.cat([xt.grad.reshape(-1)] + [
            torch.zeros_like(p).reshape(-1) if p.grad is None
            else p.grad.reshape(-1) for p in params] + [loss.detach()[None]])
        if split is not None:
            parallel.all_reduce_(flat, split.axis)
        stats = torch.cat([b.reshape(-1) for m in stages
                           for n, b in m.named_buffers()
                           if n.endswith(("running_mean", "running_var"))])
    n = xt.numel()
    return dict(logits=logits.detach().numpy(), x_grad=flat[:n].numpy(),
                grads=flat[n:-1].numpy(), loss=flat[-1:].numpy(),
                stats=stats.numpy())


def det_head():
    """The micro model with the CenterPoint head in float64 and a fixed
    finest FPN3D level (1, 16, 20, 20, 4)."""
    with float64():
        model = FBOCC(**MICRO, device="cpu", dtype=torch.float64,
                      use_detection_head=True,
                      generator=torch.Generator().manual_seed(3))
    return model, np.random.RandomState(6).randn(1, 16, 20, 20, 4)


def det_run(model, x, split=None):
    """One train-mode forward and backward of :func:`det_head`'s
    ``FBOCC.detect`` on x (this rank's rows under ``split``) with the
    trainer's detection losses on :func:`det_boxes` (under a mesh each
    rank's a 1 / world share): {the per-task maps, the loss, the head's
    parameter gradients and the input gradient summed over the split's
    ranks, the head's BatchNorm running statistics}, numpy."""
    model = copy.deepcopy(model)
    with float64():
        tr = Trainer(model, lovasz="sort")
        head = model.pts_bbox_head.train()
        xt = torch.tensor(x, requires_grad=True)
        preds = model.detect(xt if split is None else split.take(xt, 2),
                             split)
        losses = tr.losses(
            {"det_preds": preds},
            {k: torch.from_numpy(v) for k, v in det_boxes().items()})
        assert sum(k.startswith("task") for k in losses) == 12, losses
        loss = sum(losses.values())
        model.zero_grad(set_to_none=True)
        loss.backward()
        flat = torch.cat([xt.grad.reshape(-1)] + [
            torch.zeros_like(p).reshape(-1) if p.grad is None
            else p.grad.reshape(-1) for p in head.parameters()]
            + [loss.detach()[None]])
        if split is not None:
            parallel.all_reduce_(flat, split.axis)
        stats = torch.cat([b.reshape(-1) for n, b in head.named_buffers()
                           if n.endswith(("running_mean", "running_var"))])
        maps = torch.cat([v.detach().reshape(-1) for task in preds
                          for v in task.values()])
    n = xt.numel()
    return dict(maps=maps.numpy(), x_grad=flat[:n].numpy(),
                grads=flat[n:-1].numpy(), loss=flat[-1:].numpy(),
                stats=stats.numpy())


def bev_errors(got, want):
    """Each of :func:`bev_run`'s arrays: largest error over the largest
    magnitude."""
    return {k: float(np.abs(got[k] - v).max() / np.abs(v).max())
            for k, v in want.items()}


def sync_bn_case(axis):
    """``sync_batch_norm`` over ``axis`` with unequal local sizes (rank
    r holds 4 - r of 9 rows of a float64 (2, 3, 9, 5) tensor) against
    ``F.batch_norm`` on the whole: the largest errors of y, the
    statistics, dx and the summed weight and bias gradients."""
    rng = np.random.RandomState(9)
    x, gy = rng.randn(2, 3, 9, 5), rng.randn(2, 3, 9, 5)
    w, b = rng.rand(3) + 0.5, rng.randn(3)
    sizes = [4 - r for r in range(axis.size)]
    assert sum(sizes) == x.shape[2]
    a = sum(sizes[:axis.index])
    part = slice(a, a + sizes[axis.index])

    def run(xx, sync):
        xx = torch.tensor(xx, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        bt = torch.tensor(b, requires_grad=True)
        if sync:
            y, mean, var = parallel.sync_batch_norm(xx, wt, bt, 1e-5, axis)
        else:
            y = F.batch_norm(xx, None, None, wt, bt, True, 0.0, 1e-5)
            mean, var = xx.mean((0, 2, 3)), xx.var((0, 2, 3),
                                                    unbiased=False)
        (y * torch.from_numpy(gy[:, :, part] if sync else gy)).sum(
        ).backward()
        wb = torch.cat([wt.grad, bt.grad])
        if sync:
            parallel.all_reduce_(wb, axis)
        return y.detach(), mean.detach(), var.detach(), xx.grad, wb
    with float64():
        got = run(x[:, :, part], True)
        want = run(x, False)
    want = (want[0][:, :, part],) + want[1:3] + (want[3][:, :, part],
                                                 want[4])
    return {k: float((g - v).abs().max()) for k, g, v in zip(
        ("y", "mean", "var", "dx", "dw_db"), got, want)}
def loop_cfg_path():
    return os.path.join(ROOT, "fbbev_tpu_torch", "configs",
                        "fbocc-r50-tiny_synthetic.py")


def loop_cfg(**opts):
    c = Config.fromfile(loop_cfg_path())
    c.merge_from_options(dict(LOOP_CUT, **opts))
    return c


def evaluate_hist(fn, *a, **kw):
    """(confusion matrix, results) of ``fn(*a, **kw)``, which runs
    ``loop.evaluate``; ``results["logits"]`` holds every evaluated
    sample's occupancy logits, stacked (a random-weight model's labels
    can all fall in one class, which no numerical fault moves)."""
    hists, logits = [], []
    real = PL.MIoUMetric.count_miou, PL.occ_pred_to_cvpr_format

    def count(self):
        hists.append(self.hist.copy())
        return real[0](self)

    def fmt(lg, *args, **kwargs):
        logits.append(np.asarray(lg, np.float32))
        return real[1](lg, *args, **kwargs)
    PL.MIoUMetric.count_miou, PL.occ_pred_to_cvpr_format = count, fmt
    try:
        res = fn(*a, **kw)
    finally:
        PL.MIoUMetric.count_miou, PL.occ_pred_to_cvpr_format = real
    res["logits"] = np.stack(logits)
    return hists[-1], res


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def handoff(d, name, make=None):
    """``make()`` saved as ``d/name.pt`` by the rank that makes it, or,
    without ``make``, read there once it exists."""
    path = os.path.join(d, f"{name}.pt")
    if make is not None:
        torch.save(make(), path + ".tmp")
        os.replace(path + ".tmp", path)
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > TIMEOUT:
            raise TimeoutError(path)
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def child(rank: int, d: str) -> None:
    """One of the three processes: first a rank of the three-rank group
    (the ``space=3`` cases), then ranks 0 and 1 form a two-rank group of
    their own for the two-rank layouts while rank 2 makes their
    one-process references."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = {}
    parallel.distributed_init_if_needed(
        "cpu", init_method=f"file://{d}/store3", rank=rank,
        world_size=WORLD)
    space3 = parallel.make_mesh(1, WORLD, device="cpu")
    # space=3: the synchronised BatchNorm on unequal sizes, then the BEV
    # stages on this rank's rows
    out["sync_bn"] = sync_bn_case(space3.space)
    model, x, gt = bev_stages()
    want = bev_run(model, x, gt)
    with parallel.use_mesh(space3):
        split = parallel.RowSplit(space3.space, 5)
        out["rows_space3"] = split.ranges(20)
        out["bev_space3"] = bev_errors(bev_run(model, x, gt, split), want)
    # the detection head on the gathered finest level
    model, x = det_head()
    want = det_run(model, x)
    with parallel.use_mesh(space3):
        out["det_space3"] = bev_errors(det_run(model, x, split), want)
    dist.barrier()
    dist.destroy_process_group()

    trainers = {f64: micro_trainer(f64) for f64 in (False, True)}
    batch, frames = micro_batch(2), two_frames()
    if rank not in PAIR:
        # the one-process steps the two-rank layouts are held against
        # (rank 0 makes data=2's float32 one itself after its loops, which
        # evens out the ranks' time)
        handoff(d, "data2_True", lambda: micro_step(
            trainers[True], batch, loss_shards=2, f64=True))
        for f64, tr in trainers.items():
            handoff(d, f"space2_{f64}", lambda: micro_step(
                tr, frames, f64=f64))
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
        return

    parallel.distributed_init_if_needed(
        "cpu", init_method=f"file://{d}/store2", rank=rank,
        world_size=len(PAIR))
    meshes = {n: parallel.make_mesh(*LAYOUTS[n], device="cpu")
              for n in LAYOUTS}
    for n, m in meshes.items():
        out[f"mesh_{n}"] = dict(ranks=m.ranks, coords=(m.data.index,
                                                       m.space.index))
    m = meshes["data2"]
    x = torch.arange(3.0) + 10 * rank
    with parallel.use_mesh(m):
        out["collectives"] = dict(
            replicated=parallel.replicate({"x": x}, m)["x"].numpy(),
            gathered=parallel.gather_to_host({"x": x}, m)["x"],
            summed=parallel.all_reduce_sum(x, "data").numpy())

    # data=2: this rank's row of the global batch of 2; each layout's
    # comparison runs on one rank (data=2's on 0, space=2's on 1), after
    # the loops, while rank 2 makes most references; every rank digests
    # what it holds
    compare = []
    for f64, tr in trainers.items():
        got = micro_step(tr, parallel.shard_batch(batch, m), m, f64=f64)
        out[f"digest_data2_{f64}"] = step_digest(got)
        if rank == 0:
            compare.append((f"data2_{f64}", got, f64, False))
    # the per-shard loss reduction on fixed logits
    logits, gt = loss_inputs()
    tr = Trainer(trainers[False][0].model, lovasz="hist")
    lo = parallel.shard_batch({"occ_logits": logits, "gt_occupancy": gt}, m)
    with parallel.use_mesh(m):
        shares = tr.losses({"occ_logits": torch.from_numpy(lo["occ_logits"])},
                           {"gt_occupancy": torch.from_numpy(
                               lo["gt_occupancy"])})
        out["loss_reduction"] = {
            k: float(parallel.all_reduce_sum(v.detach(), "data"))
            for k, v in shares.items()}

    # space=2: this rank's camera and BEV rows of a one-sample batch
    s = meshes["space2"]
    cam, ctx, dep = pool_inputs()
    local = dict(parallel.split_cameras(cam, s), context=ctx[:, rank:rank + 1],
                 depth=dep[:, rank:rank + 1])
    fp = tr.model.forward_projection
    from fbbev_tpu_torch import geometry
    with parallel.use_mesh(s):
        out["pool_space2"] = fp(
            geometry.CamParams(*(torch.from_numpy(local[k]) for k in
                                 geometry.CamParams._fields)),
            torch.from_numpy(local["context"]),
            torch.from_numpy(local["depth"])).numpy()
    for f64, tr in trainers.items():
        got = micro_step(tr, [parallel.split_cameras(f, s) for f in frames],
                         s, f64=f64)
        out[f"digest_space2_{f64}"] = step_digest(got, history=True)
        if rank == 1:
            compare.append((f"space2_{f64}", got, f64, True))

    # the loop: two iterations, rank 0's checkpoint restored on every
    # rank, then evaluate from that checkpoint, each building its mesh
    # from the group (none is active); space=2 through the two tools
    from fbbev_tpu_torch.tools import test as test_tool
    from fbbev_tpu_torch.tools import train as train_tool
    for n, opts in LOOP_OPTS.items():
        wd = os.path.join(d, n)
        cfg = loop_cfg(**opts)
        flags = (["--device", "cpu", "--space", "2", "--work-dir", wd,
                  "--cfg-options"]
                 + [f"{k}={v}" for k, v in LOOP_CUT.items()]
                 + ["data.batch_size=1"])
        if n == "space2":
            r = train_tool.main([loop_cfg_path(), "--max-iters", "2"]
                                + flags)
        else:
            r = PL.train(cfg, max_iters=2, work_dir=wd, device="cpu")
        restored = CK.restore_checkpoint(os.path.join(wd, "ckpts"),
                                         r["trainer"].init_state())
        if n == "space2":
            hist, res = evaluate_hist(test_tool.main, [loop_cfg_path()]
                                      + flags)
        else:
            hist, res = evaluate_hist(PL.evaluate, cfg, device="cpu",
                                      work_dir=wd)
        same = all(torch.equal(a, b) for a, b in zip(
            CK.state_to_dict(r["state"]).values(),
            CK.state_to_dict(restored).values())
            if isinstance(a, torch.Tensor))
        out[f"loop_{n}"] = dict(
            same=same, step=int(restored.step), digest=digest(
                restored.params), digest_ema=digest(restored.ema_params),
            digest_stats=digest(restored.batch_stats),
            history=[h["iter"] for h in r["history"]],
            ckpts=sorted(os.listdir(os.path.join(wd, "ckpts"))),
            hist=hist, n_samples=res["n_samples"], logits=res["logits"])
    for name, got, f64, history in compare:
        want = (micro_step(trainers[False], batch, loss_shards=2)
                if name == "data2_False" else handoff(d, name))
        out[f"step_{name}"] = step_errors(got, want, f64, history)
    dist.barrier()
    dist.destroy_process_group()
    # the one-process evaluation of one layout's checkpoint, a rank each
    n = sorted(LOOP_OPTS)[rank]
    out[f"one_process_{n}"] = evaluate_hist(
        PL.evaluate, loop_cfg(**{k: v for k, v in LOOP_OPTS[n].items()
                                 if k not in ("devices", "space")}),
        device="cpu", work_dir=os.path.join(d, n))
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# The fixture and the tests.
# ---------------------------------------------------------------------------

def jax_references():
    """The JAX package's side, made while the children run: the device
    array of each layout's ``make_mesh``, ``Trainer._occ_losses_sharded``
    under a two-device ``data`` mesh on the children's fixed logits, and
    ``LSSViewTransformer3D._pool`` under ``use_mesh(make_mesh(data=1,
    space=2))`` on their pool inputs."""
    import jax
    import jax.numpy as jnp
    from fbbev_tpu import geometry as jgeo
    from fbbev_tpu.models.losses import bev_distance_weight
    from fbbev_tpu.models.lss import LSSViewTransformer3D
    from fbbev_tpu.parallel import make_mesh, use_mesh
    from fbbev_tpu.train.trainer import Trainer as JaxTrainer
    two = jax.devices()[:2]
    out = {n: np.vectorize(lambda dv: dv.id)(make_mesh(
        data=data, space=space, devices=two).devices)
        for n, (data, space) in LAYOUTS.items()}
    # jitted, as the JAX train step runs them: eager shard_map runs op by
    # op, 10-20x slower on the CPU
    logits, gt = loss_inputs()
    with use_mesh(make_mesh(data=2, devices=two)):
        out["loss_reduction"] = {
            k: float(v) for k, v in jax.jit(
                JaxTrainer(model=None)._occ_losses_sharded)(
                jnp.asarray(logits), jnp.asarray(gt),
                jnp.asarray(bev_distance_weight(8, 8))).items()}
    cam, ctx, dep = pool_inputs()
    lss = LSSViewTransformer3D(GRID, (32, 96), 16)
    coor = jgeo.frustum_to_ego(jnp.asarray(lss.frustum), jgeo.CamParams(
        **{k: jnp.asarray(v) for k, v in cam.items()}))
    with use_mesh(make_mesh(data=1, space=2, devices=two)):
        out["pool"] = np.asarray(jax.jit(lss._pool)(
            coor, jnp.asarray(dep), jnp.asarray(ctx)))
    return out


def run_group():
    """Spawn the three-rank group in a temporary directory, make
    :func:`jax_references` meanwhile, wait at most ``TIMEOUT`` s (then
    kill the children and fail): (every rank's results {rank: dict},
    the JAX references)."""
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        logs = [open(os.path.join(d, f"log{r}.txt"), "w")
                for r in range(WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), d],
            cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        t0 = time.monotonic()
        try:
            refs = jax_references()
            for p in procs:
                p.wait(timeout=max(1.0, TIMEOUT - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        rcs = [p.returncode for p in procs]
        if rcs != [0] * WORLD:
            tails = [open(os.path.join(d, f"log{r}.txt")).read()[-3000:]
                     for r in range(WORLD)]
            pytest.fail(f"three-rank group failed (exit codes {rcs}, "
                        f"{TIMEOUT} s limit):\n" + "\n----\n".join(tails))
        return {r: torch.load(os.path.join(d, f"rank{r}.pt"),
                              weights_only=False)
                for r in range(WORLD)}, refs


@pytest.fixture(scope="module")
def runs():
    """:func:`run_group`'s results.  Under xdist the tests of this file
    may land on several workers: the first to get here runs the group and
    leaves its (small) results in a directory named after the test run
    (``PYTEST_XDIST_TESTRUNUID``), removed when that worker exits; the
    others wait for them (or, the directory gone, run their own)."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return run_group()
    shared = os.path.join(tempfile.gettempdir(),
                          f"fbbev_torch_parallel_{uid}")
    done = os.path.join(shared, "results.pt")
    try:
        os.mkdir(shared)
    except FileExistsError:
        t0 = time.monotonic()
        while os.path.isdir(shared) and time.monotonic() - t0 < TIMEOUT + 60:
            if os.path.exists(done):
                return torch.load(done, weights_only=False)
            if os.path.exists(os.path.join(shared, "failed")):
                pytest.fail("the three-rank group failed on another worker")
            time.sleep(0.2)
        return run_group()
    atexit.register(shutil.rmtree, shared, True)
    try:
        res = run_group()
    except BaseException:
        open(os.path.join(shared, "failed"), "w").close()
        raise
    torch.save(res, done + ".tmp")
    os.replace(done + ".tmp", done)
    return res


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_rank_order_as_jax(runs, layout):
    """Rank r sits at (r // space, r % space): the place of device r in
    the JAX ``make_mesh`` device array of the same layout."""
    res, refs = runs
    ids, space = refs[layout], LAYOUTS[layout][1]
    for r in (0, 1):
        got = res[r][f"mesh_{layout}"]
        np.testing.assert_array_equal(got["ranks"], ids)
        assert tuple(np.argwhere(ids == r)[0]) == got["coords"]
        assert divmod(r, space) == got["coords"]


def test_collectives(runs):
    """``replicate`` is rank 0's value everywhere, ``gather_to_host``
    every rank's in rank order, ``all_reduce_sum`` their sum."""
    res, _ = runs
    x = [np.arange(3.0) + 10 * r for r in (0, 1)]
    for r in (0, 1):
        c = res[r]["collectives"]
        np.testing.assert_array_equal(c["replicated"], x[0])
        np.testing.assert_array_equal(c["gathered"], np.concatenate(x))
        np.testing.assert_array_equal(c["summed"], x[0] + x[1])


def _check_step(got, history=False):
    for k in ("grad",) + STATE + ("history",) * history:
        assert got[k] <= 1.0, (k, got[k])
    for k, v in got["metrics"].items():
        assert v <= 1.0, (k, v)


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
def test_data_parallel_step_matches_global_batch(runs, f64):
    """``data=2``: after one step both ranks hold the same parameters,
    statistics, EMA and gradient, and those, with the metrics, of the
    one-process step on the global batch with per-shard losses
    (``Trainer(loss_shards=2)``, run by rank 0)."""
    res, _ = runs
    _check_step(res[0][f"step_data2_{f64}"])
    assert res[0][f"digest_data2_{f64}"] == res[1][f"digest_data2_{f64}"]


def test_sharded_loss_reduction_matches_jax(runs):
    """The occupancy losses of each rank's batch row, reduced over
    ``data``, against JAX's ``Trainer._occ_losses_sharded`` under a
    two-device mesh on the same logits."""
    res, refs = runs
    want = refs["loss_reduction"]
    for r in (0, 1):
        got = res[r]["loss_reduction"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)


def test_space_pool_matches_jax(runs):
    """``space=2``: each rank pools its camera and the partial BEVs add
    over ``space``, JAX's ``LSSViewTransformer3D._pool`` under
    ``use_mesh(make_mesh(data=1, space=2))``."""
    res, refs = runs
    want = refs["pool"]
    assert np.abs(want).max() > 0
    for r in (0, 1):
        got = res[r]["pool_space2"]
        assert got.shape == want.shape == (1, 20, 20, 4, 32)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
def test_space_step_matches_one_process(runs, f64):
    """``space=2``: one camera and the BEV rows of the nested split a
    rank, over two frames (the second warps the history); after each
    step both ranks hold the same gradient, parameters, statistics, EMA
    and carried history, those of the one-process steps on both cameras
    (the image stage's gradient summed over ``space``, each BEV row's
    counted once by the rank that owns it)."""
    res, _ = runs
    _check_step(res[1][f"step_space2_{f64}"], history=True)
    assert res[0][f"digest_space2_{f64}"] == res[1][f"digest_space2_{f64}"]


def test_space3_detection_head_matches_one_process(runs):
    """``space=3``: ``FBOCC.detect`` on each rank's rows of the finest
    level gathers it whole and runs the CenterPoint head as a copy on
    every rank (its BatchNorms over ``data`` alone), each copy's
    detection losses a 1 / world share (``Trainer.losses``); forward and
    backward in float64 against one process on the whole level -- the
    maps, the loss, the head's gradients and the input gradient summed
    over the ranks and the running statistics within 1e-10 of their
    largest magnitude on every rank."""
    res, _ = runs
    for r in range(WORLD):
        assert sorted(res[r]["det_space3"]) == [
            "grads", "loss", "maps", "stats", "x_grad"]
        for k, v in res[r]["det_space3"].items():
            assert v <= 1e-10, (r, k, v)


def test_space3_bev_stages_match_one_process(runs):
    """``space=3`` (2/2/1 coarse rows: the middle rank has two
    neighbours): the 3D encoder, FPN3D, the occ head and the occupancy
    losses in float64 on each rank's rows, forward and backward, against
    one process on the whole grid -- the gathered logits, the loss, the
    parameter and input gradients summed over the ranks and the
    BatchNorm running statistics within 1e-10 of their largest
    magnitude on every rank."""
    res, _ = runs
    for r in range(WORLD):
        assert res[r]["rows_space3"] == [(0, 8), (8, 16), (16, 20)]
        for k, v in res[r]["bev_space3"].items():
            assert v <= 1e-10, (r, k, v)


def test_sync_batch_norm_unequal_sizes(runs):
    """``sync_batch_norm`` over three ranks holding 4, 3 and 2 rows: y,
    the statistics, dx and the summed weight and bias gradients of
    ``F.batch_norm`` on the concatenation, float64, to 1e-12."""
    res, _ = runs
    for r in range(WORLD):
        for k, v in res[r]["sync_bn"].items():
            assert v <= 1e-12, (r, k, v)


@pytest.mark.parametrize("layout", sorted(LOOP_OPTS))
def test_evaluate_matches_one_process(runs, layout):
    """``evaluate`` on two ranks (``space=2``: ``tools/test.py --space
    2``, the BEV rows split), from rank 0's checkpoint: the confusion
    matrix and ``n_samples`` of the one-process evaluation of the same
    checkpoint over the same global batch (a child runs it after the
    group); with ``space=2`` also every sample's logits, within 1e-5 of
    their largest magnitude."""
    res, _ = runs
    want, wres = [res[r][f"one_process_{layout}"] for r in (0, 1)
                  if f"one_process_{layout}" in res[r]][0]
    assert want.sum() > 0
    for r in (0, 1):
        got = res[r][f"loop_{layout}"]
        np.testing.assert_array_equal(got["hist"], want)
        assert got["n_samples"] == wres["n_samples"] == 4
        if layout == "space2":
            # the same samples in the same order on every rank (measured
            # 3.8e-7 of the largest)
            lg, wl = got["logits"], wres["logits"]
            assert lg.shape == wl.shape == (4, 40, 40, 8, 19)
            assert np.abs(lg - wl).max() <= 1e-5 * np.abs(wl).max()


@pytest.mark.parametrize("layout", sorted(LOOP_OPTS))
def test_loop_checkpoint_restored_on_every_rank(runs, layout):
    """Two iterations of ``train`` (``space=2``: ``tools/train.py --space
    2``): one checkpoint (rank 0's), which every rank restores to the
    state it holds; both ranks hold the same one."""
    res, _ = runs
    a, b = res[0][f"loop_{layout}"], res[1][f"loop_{layout}"]
    for got in (a, b):
        assert got["same"] and got["step"] == 2
        assert got["history"] == [1, 2]
        assert got["ckpts"] == ["2.pt"]
    for k in ("digest", "digest_ema", "digest_stats"):
        assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# One process, no group: the row plan, the halo widths, the split upsample.
# ---------------------------------------------------------------------------

LEVELS = {"flagship": (25, 50, 100, 200), "micro": (5, 10, 20, 40)}
PLANS = {("flagship", 2): [13, 12], ("flagship", 3): [9, 8, 8],
         ("micro", 2): [3, 2]}


@pytest.mark.parametrize("space", range(1, 7))
@pytest.mark.parametrize("grid", sorted(LEVELS))
def test_row_plan_nested(grid, space):
    """``split_rows`` at the flagship's and the micro model's BEV levels:
    every row covered once, the coarsest level split as evenly as
    possible, each level's rows its factor times the coarsest's (so each
    nested in the next); more ranks than coarse rows raise."""
    levels = LEVELS[grid]
    if space > levels[0]:
        with pytest.raises(ValueError):
            parallel.split_rows(levels[0], levels[0], space)
        return
    coarse = parallel.split_rows(levels[0], levels[0], space)
    sizes = [b - a for a, b in coarse]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    if (grid, space) in PLANS:
        assert sizes == PLANS[grid, space]
    for n in levels:
        plan = parallel.split_rows(n, levels[0], space)
        assert plan[0][0] == 0 and plan[-1][1] == n
        assert all(p[1] == q[0] for p, q in zip(plan, plan[1:]))
        f = n // levels[0]
        assert plan == [(f * a, f * b) for a, b in coarse]


def _receptive_rows(op, n_in, rows):
    """The input rows (first, last) that output ``rows`` of ``op`` on a
    whole (1, 1, n_in, 4, 2) grid read: where their gradient is not
    zero."""
    x = torch.ones(1, 1, n_in, 4, 2, requires_grad=True)
    y = op(x)
    y[:, :, rows[0]:rows[1]].sum().backward()
    hit = torch.nonzero(x.grad.abs().sum((0, 1, 3, 4))).reshape(-1)
    return int(hit[0]), int(hit[-1])


def _ones_conv(k, s):
    m = layers.conv(3, 1, 1, k, s, k // 2)
    torch.nn.init.ones_(m.weight)
    return m


# (name, the op on a whole grid, its input level's factor over its
# output's, its (lo, hi) halo)
RECEPTIVE = {
    "conv3_s1": lambda: (_ones_conv(3, 1), 1, _ones_conv(3, 1).halo_rows()),
    "conv3_s2": lambda: (_ones_conv(3, 2), 2, _ones_conv(3, 2).halo_rows()),
    "conv1_s2": lambda: (_ones_conv(1, 2), 2, _ones_conv(1, 2).halo_rows()),
    **{f"upsample{u}": (lambda u=u: (
        lambda x: F.interpolate(x, size=(u * x.shape[2], 4, 2),
                                mode="trilinear", align_corners=False),
        1 / u, (layers.UPSAMPLE_HALO,) * 2)) for u in (2, 4, 8)}}


@pytest.mark.parametrize("op", sorted(RECEPTIVE))
def test_halo_covers_receptive_rows(op):
    """For every rank of the flagship plan at ``space`` 2-6, the input
    rows each conv (3x3x3 stride 1 and 2, 1x1x1 stride 2) and each
    upsample (x2, x4, x8) reads for that rank's output rows lie within
    the rank's input rows and the halo it fetches."""
    fn, factor, (lo, hi) = RECEPTIVE[op]()
    for n_out in (25, 50, 100, 200):
        n_in = int(n_out * factor)
        if n_in not in (25, 50, 100, 200):
            continue
        for space in range(2, 7):
            outs = parallel.split_rows(n_out, 25, space)
            ins = parallel.split_rows(n_in, 25, space)
            for (a, b), rows in zip(ins, outs):
                first, last = _receptive_rows(fn, n_in, rows)
                assert a - lo <= first and last < b + hi, (
                    op, space, rows, (a, b), (first, last))


def run_ranks(S, fn):
    """``fn(axis)`` on S threads, each one rank of a simulated 'space'
    axis whose all-gather is an exchange at a barrier (the active row
    axis each thread's own): the results in rank order."""
    slots, bar, local = [None] * S, threading.Barrier(S), threading.local()
    results, errors = [None] * S, []

    def gather(t, axis):
        slots[axis.index] = t.contiguous()
        bar.wait()
        out = torch.stack(slots)
        bar.wait()
        return out

    def run(s):
        local.axis = parallel.Axis(S, s, group="simulated")
        try:
            results[s] = fn(local.axis)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
            bar.abort()
    real = (parallel.mesh.all_gather, parallel.row_axis)
    parallel.mesh.all_gather, parallel.row_axis = gather, (
        lambda: local.axis)
    try:
        threads = [threading.Thread(target=run, args=(s,)) for s in range(S)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        parallel.mesh.all_gather, parallel.row_axis = real
    if errors:
        raise errors[0]
    return results


@pytest.mark.parametrize("space", range(2, 7))
def test_split_upsample_matches_interpolate(space):
    """``resize_trilinear(rows=True)`` on each rank's rows of the
    flagship plan (Y x2, x4, x8 from the 25-row level, X and Z x2 and x4)
    concatenated equals ``F.interpolate`` on the whole grid to 1e-6 of its
    largest value, float32."""
    x = torch.from_numpy(np.random.RandomState(space).randn(
        1, 3, 25, 6, 2).astype(np.float32))
    for u in (2, 4, 8):
        size = (25 * u, 6 * min(u, 4), 2 * min(u, 4))
        want = F.interpolate(x, size=size, mode="trilinear",
                             align_corners=False)

        def rank(axis):
            a, b = parallel.split_rows(25, 25, space)[axis.index]
            return layers.resize_trilinear(
                x[:, :, a:b], (u * (b - a),) + size[1:], rows=True)
        got = torch.cat(run_ranks(space, rank), 2)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


# (name, module factory, input rows at the 25-row plan, train mode, the
# tolerance: K7's and K6's plain versions sum in float32)
SPLIT_CONVS = {
    "conv3_s1": (lambda: layers.conv(3, 64, 16, 3, 1, 1, bias=True), 50,
                 True, 1e-12),
    "conv3_s2": (lambda: layers.conv(3, 64, 16, 3, 2, 1, bias=True), 100,
                 True, 1e-12),
    "zslab_k7": (lambda: layers.conv(3, 64, 64, 3, 1, 1, bias=True,
                                     pallas3x3=True), 50, True, 1e-6),
    "k6_eval": (lambda: layers.conv(3, 64, 64, 3, 1, 1, pallas3x3=True,
                                    pallas_conv3d=True), 100, False, 1e-6),
    # the coarse level: 11 rows with the halo at space=3, one zero row
    # added for K6's gate
    "k6_eval_coarse": (lambda: layers.conv(
        3, 64, 64, 3, 1, 1, pallas3x3=True, pallas_conv3d=True), 25, False,
        1e-6),
}


@pytest.mark.parametrize("space", [2, 3, 6])
@pytest.mark.parametrize("name", sorted(SPLIT_CONVS))
def test_split_conv_matches_whole(name, space, monkeypatch):
    """Each 3D conv route marked ``row_split`` (``Conv3d`` stride 1 and
    2, the z-slab K7 route and K6 in eval, K7 and K6 by their plain
    versions here) on each rank's rows of the nested plan, with its halo,
    against the conv of the whole grid: the output rows and, in train
    mode, the input gradient rows and the weight gradient summed over the
    ranks, float64 (float32 sums in the kernels' plain versions), to 1e-12
    (1e-6) of their largest magnitude.  K6 is called once on every
    rank."""
    make, n, train, tol = SPLIT_CONVS[name]
    k6_calls = []
    real_k6 = layers.conv3d_k6.conv3d_3x3x3
    monkeypatch.setattr(layers.conv3d_k6, "conv3d_3x3x3", lambda x, w: (
        k6_calls.append(x.shape[2]), real_k6(x, w))[1])
    torch.manual_seed(space)
    m = make().double().train(train).requires_grad_(train)
    m.row_split = True
    rng = np.random.RandomState(space)
    x = rng.randn(1, 64, n, 8, 2)
    s = m.stride[0]
    out_rows = n // s
    gy = rng.randn(1, m.out_channels, out_rows, 8 // s, max(2 // s, 1))

    def run(mod, xx, gg):
        xt = torch.tensor(xx, requires_grad=train)
        y = mod(xt)
        if train:
            (y * torch.from_numpy(gg)).sum().backward()
            return (y.detach(), xt.grad, mod.weight.grad)
        return (y.detach(),)
    want = run(copy.deepcopy(m), x, gy)

    def rank(axis):
        a, b = parallel.split_rows(n, 25, space)[axis.index]
        c, d = parallel.split_rows(out_rows, 25, space)[axis.index]
        return run(copy.deepcopy(m), x[:, :, a:b], gy[:, :, c:d])
    k6_calls.clear()
    got = run_ranks(space, rank)
    assert len(k6_calls) == (space if name.startswith("k6") else 0)
    parts = [torch.cat([g[0] for g in got], 2)]
    if train:
        parts += [torch.cat([g[1] for g in got], 2),
                  sum(g[2] for g in got)]
    for g, w in zip(parts, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())


@pytest.mark.parametrize("space", [2, 3])
@pytest.mark.parametrize("kernel", ["k8", "k9"])
def test_split_occ_head_kernels_on_whole_levels(kernel, space,
                                                 monkeypatch):
    """The occ head in eval on each rank's rows of the nested plan
    (coarse levels of 5 rows, 256 channels): K8 (``occ_tail``, labels)
    and K9 (``occ_fuse`` without ``coarse_pred``, logits), by their plain
    versions here, each called once a rank on the levels gathered whole;
    the rows concatenated equal the head on the whole grid (labels
    equal, logits within 1e-10 of their largest magnitude, float64)."""
    from fbbev_tpu_torch.models import occ_head as OH
    with float64():
        torch.manual_seed(7)
        head = OH.OccHead((256,) * 3, 19, coarse_pred=kernel == "k8",
                          occ_tail=kernel == "k8", occ_fuse=kernel == "k9"
                          ).double().eval()
        for mod in head.modules():
            if hasattr(mod, "row_split"):
                mod.row_split = True
        rng = np.random.RandomState(space)
        levels = [torch.from_numpy(rng.randn(1, 256, 20 >> i, 8 >> i,
                                             4 >> i)) for i in range(3)]
        labels = kernel == "k8"
        with torch.no_grad():
            want = head(levels, return_labels=labels)
            seen = []
            for mod, name in ((OH.pallas_occ_tail, "occ_tail"),
                              (OH.pallas_occ_fuse, "fuse_multiscale")):
                real = getattr(mod, name)
                monkeypatch.setattr(mod, name, lambda lv, *a, real=real: (
                    seen.append(tuple(lv[0].shape)), real(lv, *a))[1])

            def rank(axis):
                split = parallel.RowSplit(axis, 5)
                with torch.no_grad():  # per thread
                    return head([split.take(f, 2) for f in levels],
                                return_labels=labels, split=split)
            got = torch.cat(run_ranks(space, rank), 1)
    assert seen == [(1, 64 if labels else 128, 40, 16, 8)] * space
    assert got.shape == want.shape
    if labels:
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-10 * float(
            want.abs().max())


if __name__ == "__main__":
    child(int(sys.argv[1]), sys.argv[2])
