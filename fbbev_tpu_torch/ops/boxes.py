"""3D box utilities: static-shape top-k decode helpers, circle NMS and
rotated-box IoU / NMS.  Counterpart of ``fbbev_tpu/ops/boxes.py``.

The JAX package writes no TPU kernel here (its top-k, suppression scans
and IoU are plain ``jnp``), so neither does the port: these are plain
PyTorch, batched where the decode needs it.

* :func:`top_k_2d` orders with a stable descending sort, not
  ``torch.topk``: ``jax.lax.top_k`` keeps the lower flat index first
  among equal scores, and CUDA's ``topk`` fixes no order of ties, which a
  bf16 heatmap is full of.
* :func:`circle_nms` runs its greedy K-step scan over any leading batch
  dimensions at once (every task of every sample in one loop), on the
  tensors' device with no host synchronisation inside the loop.
* :func:`rotated_iou` keeps the fixed 24-candidate intersection of the
  JAX package (4 corners of A inside B, 4 of B inside A, 16 edge-pair
  crossings, angle-sorted with invalid slots filled by the last valid
  vertex): no dynamic compaction, exact on any hardware.
"""

from __future__ import annotations

from typing import Union

import torch


def circle_nms(centers: torch.Tensor, scores: torch.Tensor,
               radius: Union[torch.Tensor, float],
               max_keep=None) -> torch.Tensor:
    """Greedy distance-based suppression, over leading batch dimensions.

    centers (..., K, 2) box centres sorted by descending score; scores
    (..., K) (unused but for the signature: every row starts kept);
    radius a scalar or (..., K) suppression radius per candidate.
    Returns keep (..., K) bool."""
    K = centers.shape[-2]
    d2 = ((centers[..., :, None, :] - centers[..., None, :, :]) ** 2).sum(-1)
    r = torch.as_tensor(radius, dtype=torch.float32,
                        device=centers.device).expand(centers.shape[:-1])
    # close[..., i, j]: candidate i lies within j's radius
    close = d2 < (r ** 2)[..., None, :]
    keep = torch.ones(centers.shape[:-1], dtype=torch.bool,
                      device=centers.device)
    for j in range(K - 1):
        # j suppresses the later candidates within its radius, if kept
        keep[..., j + 1:] &= ~(close[..., j + 1:, j] & keep[..., j:j + 1])
    return keep


def top_k_2d(scores: torch.Tensor, k: int):
    """(..., C, H, W) score map -> (..., k) scores, class ids, y, x, the
    highest first; ties in the lower flat index first, as
    ``jax.lax.top_k``."""
    C, H, W = scores.shape[-3:]
    flat = scores.reshape(*scores.shape[:-3], C * H * W)
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    cls = idx // (H * W)
    rem = idx % (H * W)
    return vals, cls, rem // W, rem % W


def _rotation(yaw: torch.Tensor) -> torch.Tensor:
    """(N,) yaw -> (N, 2, 2) rotation [[c, -s], [s, c]]."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def boxes_bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(N, >=7) [x, y, z, dx, dy, dz, yaw, ...] -> (N, 4, 2) BEV corners."""
    x, y = boxes[:, 0], boxes[:, 1]
    dx, dy = boxes[:, 3], boxes[:, 4]
    local = torch.stack([
        torch.stack([dx / 2, dy / 2], -1),
        torch.stack([dx / 2, -dy / 2], -1),
        torch.stack([-dx / 2, -dy / 2], -1),
        torch.stack([-dx / 2, dy / 2], -1),
    ], 1)  # (N, 4, 2)
    return torch.einsum("nij,nkj->nki", _rotation(boxes[:, 6]), local) + \
        torch.stack([x, y], -1)[:, None, :]


# ----------------------------------------------------------------------
# Rotated-box IoU + NMS (the mmcv ``nms_rotated`` surface; the nuScenes
# ``nms_type='rotate'`` option).  On no model path: every decode takes
# circle NMS.


def _quad_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 5) [x, y, dx, dy, yaw] -> (N, 4, 2) corners (consistent ring)."""
    x, y, dx, dy, yaw = (boxes[:, i] for i in range(5))
    local = torch.stack([
        torch.stack([dx / 2, dy / 2], -1),
        torch.stack([-dx / 2, dy / 2], -1),
        torch.stack([-dx / 2, -dy / 2], -1),
        torch.stack([dx / 2, -dy / 2], -1),
    ], 1)
    return torch.einsum("nij,nkj->nki", _rotation(yaw), local) + \
        torch.stack([x, y], -1)[:, None, :]


def _point_in_quad(pts: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """pts (..., P, 2) inside convex quad (..., 4, 2) (winding-agnostic)."""
    a = quad
    edge = torch.roll(quad, -1, dims=-2) - a                 # (..., 4, 2)
    rel = pts[..., :, None, :] - a[..., None, :, :]          # (..., P, 4, 2)
    cross = edge[..., None, :, 0] * rel[..., 1] - \
        edge[..., None, :, 1] * rel[..., 0]                  # (..., P, 4)
    eps = 1e-7
    return (cross >= -eps).all(-1) | (cross <= eps).all(-1)


def _seg_crossings(qa: torch.Tensor, qb: torch.Tensor):
    """All 16 edge-pair intersection points of two quads.

    qa/qb (..., 4, 2) -> pts (..., 16, 2), valid (..., 16)."""
    a0 = qa[..., :, None, :]                                 # (..., 4, 1, 2)
    a1 = torch.roll(qa, -1, dims=-2)[..., :, None, :]
    b0 = qb[..., None, :, :]                                 # (..., 1, 4, 2)
    b1 = torch.roll(qb, -1, dims=-2)[..., None, :, :]
    da, db = a1 - a0, b1 - b0
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    rel = b0 - a0
    safe = torch.where(denom.abs() < 1e-9, torch.ones_like(denom), denom)
    t = (rel[..., 0] * db[..., 1] - rel[..., 1] * db[..., 0]) / safe
    u = (rel[..., 0] * da[..., 1] - rel[..., 1] * da[..., 0]) / safe
    valid = (denom.abs() >= 1e-9) & (t >= 0) & (t <= 1) & (u >= 0) & \
        (u <= 1)
    pts = a0 + t[..., None] * da
    shape = pts.shape[:-3] + (16, 2)
    return pts.reshape(shape), valid.reshape(shape[:-1])


def _convex_area_from_candidates(pts: torch.Tensor,
                                 valid: torch.Tensor) -> torch.Tensor:
    """Area of the convex hull of ``pts`` rows flagged ``valid`` (pts are
    known to be exactly the polygon's vertices).

    pts (..., M, 2), valid (..., M) -> (...)."""
    M = pts.shape[-2]
    n_valid = valid.sum(-1)
    nv = n_valid.clamp(min=1).to(pts.dtype)
    cen = torch.where(valid[..., None], pts, 0.0).sum(-2) / nv[..., None]
    ang = torch.atan2(pts[..., 1] - cen[..., None, 1],
                      pts[..., 0] - cen[..., None, 0])
    key = torch.where(valid, ang, torch.inf)
    order = torch.argsort(key, dim=-1, stable=True)
    p_s = torch.take_along_dim(pts, order[..., None], dim=-2)
    v_s = torch.take_along_dim(valid, order, dim=-1)
    # fill invalid tail slots with the last valid vertex (duplicates add 0)
    ar = torch.arange(M, device=pts.device).expand(v_s.shape)
    idx = torch.where(v_s, ar, -1).cummax(-1).values.clamp(min=0)
    ring = torch.take_along_dim(p_s, idx[..., None], dim=-2)
    nxt = torch.roll(ring, -1, dims=-2)
    cross = ring[..., 0] * nxt[..., 1] - ring[..., 1] * nxt[..., 0]
    area = 0.5 * cross.sum(-1).abs()
    return torch.where(n_valid >= 3, area, 0.0)


def rotated_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise BEV IoU of rotated boxes (N, 5) x (M, 5) -> (N, M)."""
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    qa = _quad_corners(boxes_a)[:, None].expand(N, M, 4, 2)
    qb = _quad_corners(boxes_b)[None].expand(N, M, 4, 2)
    in_ab = _point_in_quad(qa, qb)                           # (N, M, 4)
    in_ba = _point_in_quad(qb, qa)
    xing, xval = _seg_crossings(qa, qb)                      # (N, M, 16, .)
    pts = torch.cat([qa, qb, xing], -2)                      # (N, M, 24, 2)
    val = torch.cat([in_ab, in_ba, xval], -1)                # (N, M, 24)
    inter = _convex_area_from_candidates(pts, val)
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    union = (area_a + area_b - inter).clamp(min=1e-7)
    return inter / union


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Greedy rotated-box NMS.

    boxes (K, 5) [x, y, dx, dy, yaw] sorted by descending score; scores
    (K,) (a score of -inf marks an invalid row).  Suppresses candidates
    with IoU > ``iou_threshold``.  Returns keep (K,) bool (static shape;
    combine with the score mask for an index list)."""
    K = boxes.shape[0]
    overlap = rotated_iou(boxes, boxes) > iou_threshold
    keep = torch.isfinite(scores)
    for j in range(K - 1):
        keep[j + 1:] &= ~(overlap[j, j + 1:] & keep[j])
    return keep
