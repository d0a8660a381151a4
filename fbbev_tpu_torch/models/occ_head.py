"""Occupancy head.  Counterpart of
``fbbev_tpu/models/occ_head.py::OccHead``.  In eval it takes the
coarse-pred reorder (``_PredConvFused``, ``coarse_pred``, on by default
as ``FBBEV_OCC_COARSE_PRED`` is): the 1x1x1 ``occ_pred_conv.0`` is
applied to each level at its own resolution before the trilinear upsample
and the softmax blend, which is exact because the conv is linear and
commutes with the per-voxel blend weights and the linear upsample; BN and
relu run after the blend as in the reference order.  In training, and in
eval with ``coarse_pred=False``, the levels are upsampled and blended
first and ``occ_pred_conv`` runs on the blend, as the JAX train path does
(``occ_head.py:108``: no reorder).

The JAX package's opt-in eval kernels are routes here, taken where its
gates hold: ``occ_tail`` (``FBBEV_OCC_TAIL=1``) runs the coarse-pred tail
from the per-level ``occ_pred_conv.0`` outputs to labels on K8 when
labels are asked for and every level divides the finest one
(``_tail_ok``, ``occ_head.py:159-172``); ``occ_fuse`` (``FBBEV_OCCFUSE=1``)
runs the blend on K9 when it is not the coarse-pred one, the channels are
a multiple of 128 and the factors are integers (``occ_head.py:188-203``).
``pallas3x3`` routes the 3x3x3 level convs to K7 through the z-slab
decomposition (``FBBEV_PALLAS3X3=1``); ``pallas_conv3d`` to K6 in eval
(``FBBEV_CONV3D=pallas``).  ``(B, C, Y, X, Z)`` inputs.

Under an active row split (``row_split``, set by ``FBOCC``) the levels
and the logits are this rank's Y rows: the deblock and the 1x1x1 convs
are row-local, ``occ_convs`` and the blend's upsamples take halos
(``layers.Conv3d``, ``layers.resize_trilinear``), and K8 and K9, which
read whole grids, run on the gathered levels and keep the rank's rows."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fbbev_tpu_torch import parallel
from fbbev_tpu_torch.models import losses as L
from fbbev_tpu_torch.models.layers import bn, conv, conv_bn_relu, \
    resize_trilinear, softmax
from fbbev_tpu_torch.ops import pallas_occ_fuse, pallas_occ_tail


class OccHead(nn.Module):
    row_split = False

    def __init__(self, in_channels: Sequence[int] = (256, 256, 256),
                 out_channel: int = 19, pallas3x3: bool = False,
                 pallas_conv3d: bool = False, coarse_pred: bool = True,
                 occ_tail: bool = False, occ_fuse: bool = False):
        super().__init__()
        mid = in_channels[0] // 2
        n_feats = len(in_channels) + 1
        self.coarse_pred, self.occ_tail, self.occ_fuse = (
            coarse_pred, occ_tail, occ_fuse)
        self.deblock = nn.Sequential(
            nn.ConvTranspose3d(in_channels[0], mid, 2, stride=2,
                               bias=False),
            bn(3, mid), nn.ReLU())
        self.occ_convs = nn.ModuleList(
            conv_bn_relu(3, c, mid, 3, 1, 1, pallas3x3=pallas3x3,
                         pallas_conv3d=pallas_conv3d)
            for c in in_channels)
        self.voxel_soft_weights = nn.Sequential(
            conv(3, mid, mid // 2, 1), bn(3, mid // 2), nn.ReLU(),
            conv(3, mid // 2, n_feats, 1))
        self.occ_pred_conv = nn.Sequential(
            conv(3, mid, mid // 2, 1), bn(3, mid // 2), nn.ReLU(),
            conv(3, mid // 2, out_channel, 1))

    def forward(self, voxel_feats, return_labels: bool = True,
                split: Optional[parallel.RowSplit] = None):
        """Returns (B, Y, X, Z) labels, or (B, Y, X, Z, classes) f32
        logits with ``return_labels=False``.  Under an active row split
        the levels and the result are this rank's Y rows and ``split`` is
        the model's (``FBOCC.bev_split``)."""
        outs = [self.deblock(voxel_feats[0])] + [
            m(f) for m, f in zip(self.occ_convs, voxel_feats)]
        w = softmax(self.voxel_soft_weights(outs[0]), 1)
        target = outs[0].shape[2:]
        conv1, bn1 = self.occ_pred_conv[0], self.occ_pred_conv[1]
        coarse = self.coarse_pred and not self.training
        rows = self.row_split and parallel.row_axis() is not None
        if rows and split is None:
            raise ValueError("the levels are split rows: pass split=")

        def whole(levels):
            # K8 and K9 read whole grids: the levels gathered
            return [split.gather(f, 2) for f in levels] if rows else levels

        def mine(y, dim):
            return split.take(y, dim) if rows else y
        if coarse:
            ys = [conv1(f) for f in outs]
            if (return_labels and self.occ_tail
                    and pallas_occ_tail.int_factors(ys, target)):
                a = bn1.weight.float() * torch.rsqrt(
                    bn1.running_var.float() + bn1.eps)
                b = bn1.bias.float() - bn1.running_mean.float() * a
                k2 = self.occ_pred_conv[3].weight[:, :, 0, 0, 0].t()
                return mine(pallas_occ_tail.occ_tail(
                    whole(ys), whole([w.to(ys[0].dtype)])[0], a, b, k2), 1)
            fused = _blend(ys, w, target, rows)
        elif (not self.training and self.occ_fuse
              and outs[0].shape[1] % 128 == 0
              and pallas_occ_tail.int_factors(outs, target)):
            # (the nested row plan keeps a split level's factors whole)
            fused = conv1(mine(pallas_occ_fuse.fuse_multiscale(
                whole(outs), whole([w.to(outs[0].dtype)])[0]), 2))
        else:
            fused = conv1(_blend(outs, w, target, rows))
        y = F.relu(bn1(fused))
        logits = self.occ_pred_conv[3](y).float()
        if return_labels:
            return logits.argmax(1)
        return logits.permute(0, 2, 3, 4, 1)


def _blend(levels, w, target, rows=False):
    """Upsample every level to ``target`` and blend with ``w``: the JAX
    package's XLA expression (``occ_head.py:211-216``); ``rows``: on this
    rank's rows of a row split."""
    fused = 0
    for i, f in enumerate(levels):
        if f.shape[2:] != target:
            f = resize_trilinear(f, target, rows)
        fused = fused + f * w[:, i:i + 1]
    return fused


def downsample_gt_mode_pool(target: torch.Tensor, ratio: int,
                            empty_idx: int = 18,
                            num_classes: int = 19) -> torch.Tensor:
    """GT mode-pooling for coarse supervision, counterpart of
    ``occ_head.py:274`` with the reference's quirks: blocks whose label
    sum equals ``empty_idx`` take the raw mode; elsewhere label-0 voxels
    never win, and a block whose non-zero labels are all distinct becomes
    255; ties go to the smallest value (``torch.mode``)."""
    B, H, W, D = target.shape
    r = ratio
    t = target.reshape(B, H // r, r, W // r, r, D // r, r)
    t = t.permute(0, 1, 3, 5, 2, 4, 6).reshape(
        B, H // r, W // r, D // r, r ** 3).long()
    raw_block = t.sum(-1) == empty_idx
    values = torch.cat([torch.arange(num_classes, device=t.device),
                        torch.tensor([255], device=t.device)])
    cnt = (t[..., None, :] == values[:, None]).sum(-1)     # (..., V)
    has_zero = cnt[..., 0] > 0
    eff = cnt.clone()
    eff[..., 0] = cnt[..., 0] * raw_block.long()
    max_eff = eff.max(-1).values
    mode_label = values[torch.argmax(eff, dim=-1)]
    negative_wins = ~raw_block & has_zero & (max_eff <= 1)
    return torch.where(negative_wins, torch.full_like(mode_label, 255),
                       mode_label)


def occ_losses(logits: torch.Tensor, target: torch.Tensor,
               class_weights: torch.Tensor, dist_weight: torch.Tensor,
               empty_idx: int = 18, use_focal: bool = True,
               lovasz: str = "hist"):
    """The four voxel losses (tag c_0), counterpart of
    ``occ_head.py:318``; the GT is mode-pooled first when it is finer than
    the logits.  ``lovasz`` picks the Lovasz form ("hist" or "sort")."""
    ratio = target.shape[1] // logits.shape[1]
    if ratio != 1:
        target = downsample_gt_mode_pool(target, ratio, empty_idx)
    logits = torch.nan_to_num(logits, nan=0.0, posinf=0.0, neginf=0.0)
    out = {}
    if use_focal:
        out["loss_voxel_ce_c_0"] = L.focal_ce_loss(
            logits, target, class_weights, dist_weight)
    else:
        out["loss_voxel_ce_c_0"] = L.ce_ssc_loss(logits, target,
                                                 class_weights)
    out["loss_voxel_sem_scal_c_0"] = L.sem_scal_loss(logits, target)
    out["loss_voxel_geo_scal_c_0"] = L.geo_scal_loss(
        logits, target, non_empty_idx=empty_idx)
    out["loss_voxel_lovasz_c_0"] = L.lovasz_softmax_loss(logits, target,
                                                         method=lovasz)
    return out
