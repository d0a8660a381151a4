"""Occupancy losses: focal CE, sem/geo scal, Lovasz softmax, weighted CE.
Counterpart of ``fbbev_tpu/models/losses.py``, float32 throughout.

Labels use the fix_void convention: 0 = void (weight 0), 1..17 =
semantics, 18 = free, 255 = ignore.  Ignored voxels enter every loss as
masked terms, so shapes stay static as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# Occ3D-nuScenes voxel counts, classes 0..16 + free (nusc_param.py:14-33)
NUSC_CLASS_FREQUENCIES = np.array([
    944004, 1897170, 152386, 2391677, 16957802, 724139, 189027, 2074468,
    413451, 2384460, 5916653, 175883646, 4275424, 51393615, 61411620,
    105975596, 116424404, 1892500630,
], np.float64)


def occ_class_weights(num_classes: int = 19) -> np.ndarray:
    """1/log(freq) class weights; with 19 outputs class 0 (void) gets 0."""
    w = 1.0 / np.log(NUSC_CLASS_FREQUENCIES[: num_classes] + 0.001)
    if num_classes == 19:
        w = np.concatenate([[0.0], 1.0 / np.log(
            NUSC_CLASS_FREQUENCIES[:18] + 0.001)])
    return w.astype(np.float32)


def bev_distance_weight(h: int = 200, w: int = 200) -> np.ndarray:
    """Radial BEV weight in [1, 2]."""
    yy, xx = np.meshgrid(np.arange(h) - h / 2, np.arange(w) - w / 2,
                         indexing="ij")
    c = np.sqrt(xx ** 2 + yy ** 2)
    return (c / c.max() + 1.0).astype(np.float32)


def _onehot(labels: torch.Tensor, valid: torch.Tensor, C: int):
    """One-hot of ``labels`` with the ignored ones all zero."""
    t = torch.where(valid, labels, torch.zeros_like(labels)).long()
    return F.one_hot(t, C).float() * valid[..., None].float()


def focal_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                  class_weights: torch.Tensor,
                  dist_weight: Optional[torch.Tensor] = None,
                  gamma: float = 2.0, alpha: float = 0.25,
                  loss_weight: float = 100.0,
                  ignore_index: int = 255) -> torch.Tensor:
    """Sigmoid focal loss over one-hot voxel labels: logits (B, H, W, D,
    C), target (B, H, W, D), class_weights (C,), dist_weight (H, W)."""
    B, H, W, D, C = logits.shape
    logits = logits.float()
    valid = target != ignore_index
    onehot = F.one_hot(torch.where(valid, target, torch.zeros_like(
        target)).long(), C).float()
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * onehot + p * (1.0 - onehot)
    focal_w = (alpha * onehot + (1 - alpha) * (1 - onehot)) * pt ** gamma
    bce = (torch.clamp(logits, min=0) - logits * onehot
           + torch.log1p(torch.exp(-torch.abs(logits))))
    loss = bce * focal_w
    if dist_weight is None:
        dist_weight = torch.ones(H, W, device=logits.device)
    wmask = (class_weights[None, None, None, None, :]
             * dist_weight[None, :, :, None, None])
    loss = (loss * wmask).sum(-1)
    loss = (loss * valid).sum() / torch.clamp(valid.sum().float(), min=1.0)
    return loss_weight * loss


def _neg_log(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return -torch.log(torch.clamp(x, eps, 1.0 - eps))


def geo_scal_loss(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: int = 255,
                  non_empty_idx: int = 18) -> torch.Tensor:
    """Occupied/free precision, recall and specificity loss."""
    pred = torch.softmax(logits.float(), dim=-1)
    valid = target != ignore_index
    empty_probs = pred[..., non_empty_idx] * valid
    nonempty_probs = (1.0 - pred[..., non_empty_idx]) * valid
    nonempty_target = ((target != non_empty_idx) & valid).float()
    eps = 1e-5
    inter = (nonempty_target * nonempty_probs).sum()
    precision = inter / (nonempty_probs.sum() + eps)
    recall = inter / (nonempty_target.sum() + eps)
    empty_target = (valid & (target == non_empty_idx)).float()
    spec = (empty_target * empty_probs).sum() / (empty_target.sum() + eps)
    return _neg_log(precision) + _neg_log(recall) + _neg_log(spec)


def sem_scal_loss(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: int = 255) -> torch.Tensor:
    """Per-class precision/recall/specificity loss over classes 1..C-2
    (all of them with C != 19), batched over classes."""
    C = logits.shape[-1]
    pred = torch.softmax(logits.float(), dim=-1).reshape(-1, C)
    labels = target.reshape(-1)
    valid = labels != ignore_index
    validf = valid.float()[:, None]
    P = pred * validf
    T = _onehot(labels, valid, C)
    nom = (P * T).sum(0)
    sum_p = P.sum(0)
    sum_t = T.sum(0)
    not_t = validf - T
    sum_not_t = not_t.sum(0)
    spec_num = ((validf - P) * not_t).sum(0)
    precision = nom / (sum_p + 1e-5)
    recall = nom / (sum_t + 1e-5)
    specificity = spec_num / (sum_not_t + 1e-5)
    zero = torch.zeros_like(nom)
    loss_c = (torch.where(sum_p > 0, _neg_log(precision), zero)
              + _neg_log(recall)
              + torch.where(sum_not_t > 0, _neg_log(specificity), zero))
    begin = 1 if C == 19 else 0
    cls = torch.arange(C, device=logits.device)
    present = (sum_t > 0) & (cls >= begin) & (cls < C - 1)
    total = torch.where(present, loss_c, zero).sum()
    return total / torch.clamp(present.float().sum(), min=1.0)


def lovasz_softmax_loss(logits: torch.Tensor, target: torch.Tensor,
                        ignore_index: int = 255,
                        method: str = "hist", nbins: int = 2048
                        ) -> torch.Tensor:
    """Multi-class Lovasz-softmax over the present classes.  ``method``
    "sort" is exact (one sort of the (C, N) errors); "hist", the JAX
    package's default, quantises the errors to ``nbins`` levels and builds
    per-class histograms, equal to the exact Lovasz of the quantised
    errors (within one bin width of "sort")."""
    C = logits.shape[-1]
    probas = torch.softmax(logits.float(), dim=-1).reshape(-1, C)
    labels = target.reshape(-1)
    valid = labels != ignore_index
    fg = _onehot(labels, valid, C)                       # (N, C)
    errors = torch.where(valid[:, None], torch.abs(fg - probas),
                         torch.zeros_like(probas))
    if method == "hist":
        return _lovasz_hist(errors.t(), fg.t(), nbins)
    if method != "sort":
        raise ValueError(f"lovasz method {method!r}")
    errors_sorted, order = torch.sort(errors.t(), dim=1, descending=True,
                                      stable=True)
    fg_sorted = torch.gather(fg.t(), 1, order)
    gts = fg_sorted.sum(1, keepdim=True)                 # (C, 1)
    inter = gts - torch.cumsum(fg_sorted, 1)
    union = gts + torch.cumsum(1.0 - fg_sorted, 1)
    jaccard = 1.0 - inter / union
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], 1)
    loss_c = (torch.clamp(errors_sorted, min=0.0) * grad).sum(1)
    present = gts[:, 0] > 0
    total = torch.where(present, loss_c, torch.zeros_like(loss_c)).sum()
    return total / torch.clamp(present.float().sum(), min=1.0)


def _lovasz_hist(e_t: torch.Tensor, fg_t: torch.Tensor,
                 nbins: int) -> torch.Tensor:
    """Counting-sort Lovasz (``losses.py:220``): per class, the count, fg
    sum and error sum of each error bin (scatter-adds in place of the
    JAX package's one-hot matmuls), then the Jaccard index at bin ends:
    ``loss_c = sum_b (J(b) - J(b-1)) * mean_error(b)``.  The gradient
    reaches the logits through the error sums."""
    C = e_t.shape[0]
    idx = torch.round(e_t * (nbins - 1)).long()
    zeros = torch.zeros(C, nbins, dtype=e_t.dtype, device=e_t.device)
    cnt = zeros.scatter_add(1, idx, torch.ones_like(e_t))
    fgs = zeros.scatter_add(1, idx, fg_t)
    es = zeros.scatter_add(1, idx, e_t)
    cnt_d, fgs_d, es_d = (t.flip(1) for t in (cnt, fgs, es))
    gts = fg_t.sum(1, keepdim=True)
    cum_cnt = torch.cumsum(cnt_d, 1)
    cum_fg = torch.cumsum(fgs_d, 1)
    inter = gts - cum_fg
    union = gts + (cum_cnt - cum_fg)
    jacc = 1.0 - inter / torch.clamp(union, min=1e-9)
    jacc_prev = torch.cat([torch.zeros_like(jacc[:, :1]), jacc[:, :-1]], 1)
    mean_e = es_d / torch.clamp(cnt_d, min=1.0)
    loss_c = ((jacc - jacc_prev) * mean_e).sum(1)
    present = gts[:, 0] > 0
    total = torch.where(present, loss_c, torch.zeros_like(loss_c)).sum()
    return total / torch.clamp(present.float().sum(), min=1.0)


def ce_ssc_loss(logits: torch.Tensor, target: torch.Tensor,
                class_weights: torch.Tensor,
                ignore_index: int = 255) -> torch.Tensor:
    """Class-weighted cross entropy with an ignore label; the mean weighted
    by the per-voxel class weight (``CrossEntropyLoss`` 'mean')."""
    logits = logits.float()
    valid = target != ignore_index
    t = torch.where(valid, target, torch.zeros_like(target)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, t[..., None])[..., 0]
    w = class_weights[t] * valid
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-6)
