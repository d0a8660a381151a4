"""CenterPoint detection head (the FB-BEV 3D detection path).
Counterpart of ``fbbev_tpu/models/centerpoint_head.py``: the head
(``SeparateHead``, ``CenterHead``), the dense Gaussian target assignment,
the focal + L1 losses and the top-K decode with circle NMS.

Module and parameter names are the reference's (mmdet3d
``CenterHead``): ``shared_conv.{conv,bn}``,
``task_heads.{t}.{name}.0.{conv,bn}`` and ``task_heads.{t}.{name}.1``,
so a converted JAX tree and an mmdet3d checkpoint load alike.  The head
takes an NCHW BEV and returns, per task, a dict of float32 channels-last
(B, H, W, C) maps, the JAX package's layout.  Its 3x3 ConvBN convs run on
K7 with ``pallas3x3`` wherever the JAX routing gate holds, as JAX's
``ConvBN`` takes ``PallasConv3x3`` (``layers.py:373-376``); the final
convs are plain ``nn.Conv`` in JAX and ``nn.Conv2d`` here.

The targets, losses and decode are functional and batched: dense
(B, M, H, W) Gaussians max-combined per channel (no per-object
painting), and one decode for every task of every sample (one sort, one
K-step circle-NMS scan), so the decode's loop runs K steps whatever the
batch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fbbev_tpu_torch.models.layers import Conv2d, ConvModule
from fbbev_tpu_torch.ops.boxes import circle_nms, top_k_2d
from fbbev_tpu_torch.registry import HEADS

# standard nuScenes task split (CenterPoint)
NUSCENES_TASKS: Tuple[Tuple[str, ...], ...] = (
    ("car",),
    ("truck", "construction_vehicle"),
    ("bus", "trailer"),
    ("barrier",),
    ("motorcycle", "bicycle"),
    ("pedestrian", "traffic_cone"),
)
NUSCENES_CLASSES = [c for t in NUSCENES_TASKS for c in t]

REG_HEADS = (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))
# every task's branches, in the order of the JAX head
BRANCHES = tuple(name for name, _ in REG_HEADS) + ("heatmap",)

# the heatmap's final bias at initialisation: sigmoid(-2.19) = 0.1
HEATMAP_INIT_BIAS = -2.19


class SeparateHead(nn.Module):
    """Per-task prediction branches, each ``Sequential(ConvModule(3x3,
    bias, BN, ReLU), Conv2d(3x3, bias))``; the heatmap's final bias starts
    at -2.19."""

    def __init__(self, in_channels: int, heatmap_classes: int,
                 head_conv: int = 64, pallas3x3: bool = False):
        super().__init__()
        self.heads = REG_HEADS + (("heatmap", heatmap_classes),)
        for name, ch in self.heads:
            self.add_module(name, nn.Sequential(
                ConvModule(2, in_channels, head_conv, 3, padding=1,
                           bias=True, pallas3x3=pallas3x3),
                Conv2d(head_conv, ch, 3, padding=1, bias=True)))
        self.init_heatmap_bias()

    @torch.no_grad()
    def init_heatmap_bias(self) -> None:
        self.heatmap[1].bias.fill_(HEATMAP_INIT_BIAS)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, C, H, W) -> {name: (B, H, W, ch) float32}."""
        return {name: getattr(self, name)(x).permute(0, 2, 3, 1).float()
                for name, _ in self.heads}


@HEADS.register
class CenterHead(nn.Module):
    """``shared_conv`` (3x3 ConvBN + ReLU, with bias) then one
    :class:`SeparateHead` per task."""

    def __init__(self, in_channels: int = 256,
                 tasks: Sequence[Sequence[str]] = NUSCENES_TASKS,
                 share_conv_channel: int = 64, pallas3x3: bool = False):
        super().__init__()
        self.tasks = tuple(tuple(t) for t in tasks)
        self.pallas3x3 = pallas3x3
        self.shared_conv = ConvModule(2, in_channels, share_conv_channel, 3,
                                      padding=1, bias=True,
                                      pallas3x3=pallas3x3)
        self.task_heads = nn.ModuleList(
            SeparateHead(share_conv_channel, len(t), pallas3x3=pallas3x3)
            for t in self.tasks)

    def forward(self, bev: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """bev (B, C, H, W) -> one dict of (B, H, W, ch) float32 maps per
        task."""
        if self.pallas3x3:
            # K7 reads channels-last memory (free if bev is in it already)
            bev = bev.contiguous(memory_format=torch.channels_last)
        x = self.shared_conv(bev)
        return [head(x) for head in self.task_heads]


# ---------------------------------------------------------------------------
# target assignment (mmdet3d get_targets in dense form)
# ---------------------------------------------------------------------------

def gaussian_radius(dy, dx, min_overlap: float = 0.1):
    """mmdet3d gaussian_radius (the CenterNet three-case formula)."""
    a1 = 1.0
    b1 = dy + dx
    c1 = dx * dy * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt((b1 ** 2 - 4 * a1 * c1).clamp(min=0.0))
    r1 = (b1 + sq1) / 2

    a2 = 4.0
    b2 = 2 * (dy + dx)
    c2 = (1 - min_overlap) * dx * dy
    sq2 = torch.sqrt((b2 ** 2 - 4 * a2 * c2).clamp(min=0.0))
    r2 = (b2 + sq2) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (dy + dx)
    c3 = (min_overlap - 1) * dx * dy
    sq3 = torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0.0))
    r3 = (b3 + sq3) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def _class_to_task(tasks, class_names, device):
    """(len(class_names) + 1,) task id and in-task channel of each class
    (-1: in no task; the last entry stands for padding labels)."""
    where = {c: (t, j) for t, tc in enumerate(tasks) for j, c in enumerate(tc)}
    task = torch.full((len(class_names) + 1,), -1, dtype=torch.long)
    chan = torch.full((len(class_names) + 1,), -1, dtype=torch.long)
    for i, c in enumerate(class_names):
        if c in where:
            task[i], chan[i] = where[c]
    return task.to(device), chan.to(device)


def centerpoint_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                        tasks: Sequence[Sequence[str]],
                        class_names: Sequence[str],
                        grid_size: Tuple[int, int],
                        pc_range: Sequence[float],
                        voxel_size: Tuple[float, float],
                        out_factor: int = 1,
                        gaussian_overlap: float = 0.1,
                        min_radius: float = 2.0,
                        norm_bbox: bool = True):
    """Dense Gaussian heatmaps + regression targets.

    gt_boxes (B, M, 9) padded boxes [x, y, z, dx, dy, dz, yaw, vx, vy];
    gt_labels (B, M) class ids into ``class_names``, -1 = padding;
    grid_size (W, H) heatmap cells (x, y); voxel_size (vx, vy) metres per
    cell / out_factor.

    Returns per task: dict(heatmap (B, H, W, Ct), anno (B, M, 10), inds
    (B, M), mask (B, M) restricted to that task's objects)."""
    gt_boxes = gt_boxes.float()
    dev = gt_boxes.device
    W, H = grid_size
    vx, vy = voxel_size[0] * out_factor, voxel_size[1] * out_factor
    x0, y0 = pc_range[0], pc_range[1]

    cx = (gt_boxes[..., 0] - x0) / vx
    cy = (gt_boxes[..., 1] - y0) / vy
    dx_c = gt_boxes[..., 3] / vx
    dy_c = gt_boxes[..., 4] / vy
    radius = torch.floor(gaussian_radius(dy_c, dx_c, gaussian_overlap)
                         ).clamp(min=min_radius)
    cxi = cx.to(torch.int32)   # truncation toward zero, as astype(int32)
    cyi = cy.to(torch.int32)
    in_grid = (cxi >= 0) & (cxi < W) & (cyi >= 0) & (cyi < H) & \
        (gt_boxes[..., 3] > 0) & (gt_boxes[..., 4] > 0)

    gx = torch.arange(W, dtype=torch.float32, device=dev)
    gy = torch.arange(H, dtype=torch.float32, device=dev)

    dims = gt_boxes[..., 3:6]
    if norm_bbox:
        dims = torch.log(dims.clamp(min=1e-3))
    anno = torch.cat([
        (cx - cxi)[..., None], (cy - cyi)[..., None],
        gt_boxes[..., 2:3], dims,
        torch.sin(gt_boxes[..., 6:7]), torch.cos(gt_boxes[..., 6:7]),
        gt_boxes[..., 7:9],
    ], -1)  # (B, M, 10)
    inds = cyi.clamp(0, H - 1).long() * W + cxi.clamp(0, W - 1).long()

    cls_task, cls_chan = _class_to_task(tasks, class_names, dev)
    labels = gt_labels.long()
    labels_safe = torch.where(labels >= 0, labels, len(class_names))
    obj_task, obj_chan = cls_task[labels_safe], cls_chan[labels_safe]

    # the clipped Gaussian of every object, (B, M, H, W), shared by tasks
    ddx = gx[None, None, :] - cxi[..., None].float()
    ddy = gy[None, None, :] - cyi[..., None].float()
    sigma = (2 * radius + 1) / 6.0
    g = torch.exp(-(ddx[:, :, None, :] ** 2 + ddy[:, :, :, None] ** 2)
                  / (2.0 * sigma[..., None, None] ** 2))
    inside = (ddx.abs()[:, :, None, :] <= radius[..., None, None]) & \
        (ddy.abs()[:, :, :, None] <= radius[..., None, None])
    g = g * inside
    targets = []
    for t, tc in enumerate(tasks):
        task_mask = (obj_task == t) & in_grid & (labels >= 0)
        chan = F.one_hot(torch.where(task_mask, obj_chan, 0), len(tc)) * \
            task_mask[..., None]
        gt = g * task_mask[..., None, None]
        heatmap = (gt[..., None] * chan[:, :, None, None, :]).amax(1)
        targets.append(dict(heatmap=heatmap, anno=anno, inds=inds,
                            mask=task_mask))
    return targets


def gaussian_focal_loss(pred_logits: torch.Tensor, gt_heatmap: torch.Tensor,
                        alpha: float = 2.0, gamma: float = 4.0):
    """mmdet GaussianFocalLoss, averaged over the positives."""
    p = torch.sigmoid(pred_logits.float())
    eps = 1e-12
    pos = (gt_heatmap >= 1.0 - 1e-4).float()
    neg_w = torch.pow(1.0 - gt_heatmap, gamma)
    pos_loss = -torch.log(p + eps) * torch.pow(1 - p, alpha) * pos
    neg_loss = -torch.log(1 - p + eps) * torch.pow(p, alpha) * neg_w * \
        (1 - pos)
    num_pos = pos.sum().clamp(min=1.0)
    return (pos_loss.sum() + neg_loss.sum()) / num_pos


CODE_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)


def centerpoint_loss(preds: List[Dict[str, torch.Tensor]],
                     targets: List[Dict[str, torch.Tensor]],
                     loss_bbox_weight: float = 0.25):
    """Heatmap focal + masked L1 on the 10-dim regression vector:
    ``task{t}_loss_heatmap`` and ``task{t}_loss_bbox`` per task."""
    losses = {}
    for t, (pred, tgt) in enumerate(zip(preds, targets)):
        losses[f"task{t}_loss_heatmap"] = gaussian_focal_loss(
            pred["heatmap"], tgt["heatmap"])
        reg = torch.cat([pred["reg"], pred["height"], pred["dim"],
                         pred["rot"], pred["vel"]], -1)   # (B, H, W, 10)
        B, H, W, _ = reg.shape
        picked = torch.take_along_dim(reg.reshape(B, H * W, 10),
                                      tgt["inds"][..., None], dim=1)
        mask = tgt["mask"][..., None].float()
        l1 = (picked - tgt["anno"]).abs() * mask * reg.new_tensor(
            CODE_WEIGHTS)
        num = mask.sum().clamp(min=1.0)
        losses[f"task{t}_loss_bbox"] = loss_bbox_weight * l1.sum() / num
    return losses


def centerpoint_decode(preds: List[Dict[str, torch.Tensor]],
                       tasks: Sequence[Sequence[str]],
                       pc_range: Sequence[float],
                       voxel_size: Tuple[float, float],
                       out_factor: int = 1, k: int = 100,
                       score_threshold: float = 0.1,
                       nms_radius: float = 4.0,
                       norm_bbox: bool = True):
    """Top-K decode + circle NMS of every task of every sample at once.

    preds: per task (B, H, W, ch) maps.  Returns (boxes (B, T*k, 9),
    scores (B, T*k), labels (B, T*k)) with static shapes, task by task
    (rows t*k .. t*k + k - 1 are task t's, by descending score); invalid
    rows (suppressed or at most ``score_threshold``) have score -1.  Row b
    is the JAX package's ``centerpoint_decode`` of sample b."""
    T = len(tasks)
    B, H, W, _ = preds[0]["heatmap"].shape
    cmax = max(len(c) for c in tasks)
    dev = preds[0]["heatmap"].device
    # every task's sigmoid scores in one (B, T, cmax, H, W) map; a task
    # with fewer classes is padded with -1, below every score, after its
    # own channels in flat order
    hm = torch.full((B, T, cmax, H, W), -1.0, device=dev)
    for t, pred in enumerate(preds):
        hm[:, t, :pred["heatmap"].shape[-1]] = torch.sigmoid(
            pred["heatmap"].float()).permute(0, 3, 1, 2)
    scores, cls, ys, xs = top_k_2d(hm, k)                  # (B, T, k)
    flat_idx = ys * W + xs

    def pick(name):
        v = torch.stack([p[name].float().reshape(B, H * W, -1)
                         for p in preds], 1)               # (B, T, HW, d)
        return torch.take_along_dim(v, flat_idx[..., None], dim=2)

    reg, hei, dim, rot, vel = (pick(n) for n, _ in REG_HEADS)
    x = (xs.float() + reg[..., 0]) * voxel_size[0] * out_factor + \
        pc_range[0]
    y = (ys.float() + reg[..., 1]) * voxel_size[1] * out_factor + \
        pc_range[1]
    if norm_bbox:
        dim = torch.exp(dim)
    yaw = torch.atan2(rot[..., 0], rot[..., 1])
    boxes = torch.cat([x[..., None], y[..., None], hei, dim, yaw[..., None],
                       vel], -1)                           # (B, T, k, 9)
    keep = circle_nms(torch.stack([x, y], -1), scores, nms_radius)
    valid = keep & (scores > score_threshold)
    scores = torch.where(valid, scores, -1.0)
    base = torch.tensor([0] + [len(c) for c in tasks[:-1]],
                        device=dev).cumsum(0)
    labels = cls + base[None, :, None]
    return (boxes.reshape(B, T * k, 9), scores.reshape(B, T * k),
            labels.reshape(B, T * k))
