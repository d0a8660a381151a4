"""Depth-weighted voxel pooling (the LSS "splat") as a differentiable
segment sum.  Counterpart of ``fbbev_tpu/ops/bev_pool.py``.

For every frustum point p,
``out[rank[p], c] += depth[p] * feat[pixel(p), c]``; points outside the
grid go to a dump row that is dropped.  ``index_add`` carries the
gradient to both depth and features.  The training path computes the
ranks on the device from each batch's geometry (:func:`lss_voxel_pool`);
serving computes them once per rig on the host and pools with K2
(``ops/pallas_pool.py``), whose plain version is
:func:`lss_voxel_pool_precomputed`.
"""

from __future__ import annotations

from typing import Sequence

import torch


def lss_voxel_pool_precomputed(ranks_bev: torch.Tensor, depth: torch.Tensor,
                               feat: torch.Tensor,
                               grid_size: Sequence[int]) -> torch.Tensor:
    """``depth (B, N, D, fH, fW)``, ``feat (B, N, fH, fW, C)``, ranks
    ``(P,)`` in natural (b, n, d, h, w) point order with dump rank
    ``B*nz*ny*nx`` -> ``(B, Y, X, Z, C)``.  Counterpart of
    ``bev_pool.py:180``."""
    B, N, D, fH, fW = depth.shape
    C = feat.shape[-1]
    nx, ny, nz = (int(g) for g in grid_size)
    V = B * nz * ny * nx
    prod = (depth[..., None] * feat[:, :, None]).reshape(-1, C)
    out = torch.zeros(V + 1, C, dtype=prod.dtype, device=prod.device)
    out = out.index_add(0, ranks_bev.to(torch.int64), prod)
    return out[:V].reshape(B, nz, ny, nx, C).permute(0, 2, 3, 1, 4)


def voxel_ranks(coor: torch.Tensor, grid_lower: Sequence[float],
                grid_interval: Sequence[float],
                grid_size: Sequence[int]) -> torch.Tensor:
    """``(P,)`` int64 voxel rank of every point of ``coor (B, ..., 3)``
    (ego metres), ``b*(nz*ny*nx) + z*(ny*nx) + y*nx + x``, dump rank
    ``B*nz*ny*nx`` outside the grid.  Truncation toward zero, as torch's
    ``.long()`` in the reference and ``geometry.voxel_coords`` in JAX."""
    B = coor.shape[0]
    nx, ny, nz = (int(g) for g in grid_size)
    f32 = (lambda v: torch.tensor(v, dtype=torch.float32,
                                  device=coor.device))
    ci = ((coor.float() - f32(grid_lower)) / f32(grid_interval)).to(
        torch.int32).reshape(B, -1, 3).long()
    valid = ((ci[..., 0] >= 0) & (ci[..., 0] < nx) & (ci[..., 1] >= 0)
             & (ci[..., 1] < ny) & (ci[..., 2] >= 0) & (ci[..., 2] < nz))
    per = nz * ny * nx
    rank = (torch.arange(B, device=coor.device)[:, None] * per
            + ci[..., 2] * (ny * nx) + ci[..., 1] * nx + ci[..., 0])
    return torch.where(valid, rank, B * per).reshape(-1)


def lss_voxel_pool(coor: torch.Tensor, depth: torch.Tensor,
                   feat: torch.Tensor, grid_lower: Sequence[float],
                   grid_interval: Sequence[float],
                   grid_size: Sequence[int]) -> torch.Tensor:
    """Lift-splat pooling from per-batch frustum coordinates.  Counterpart
    of ``bev_pool.py:112``.

    coor (B, N, D, fH, fW, 3) ego xyz; depth (B, N, D, fH, fW); feat
    (B, N, fH, fW, C) -> (B, Y, X, Z, C) in depth's and feat's type."""
    ranks = voxel_ranks(coor, grid_lower, grid_interval, grid_size)
    return lss_voxel_pool_precomputed(ranks, depth, feat, grid_size)
