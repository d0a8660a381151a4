"""Bilinear and trilinear grid sampling, channels-last, as gathers.
Counterpart of ``fbbev_tpu/ops/grid_sample.py::grid_sample_2d`` (:40) and
``grid_sample_3d`` (:173), the exact formulations of the JAX package: the
four or eight corners gathered and weighted, zero outside the image or
volume (``padding_mode='zeros'``); autograd gives the backward."""

from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int,
                 align_corners: bool) -> torch.Tensor:
    """[-1, 1] -> index coordinates (torch ``grid_sample`` convention)."""
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = False) -> torch.Tensor:
    """img (B, H, W, C); grid (B, ..., 2) of (x, y) in [-1, 1] -> (B, ...,
    C): the four corners, each weighted by its bilinear weight where it
    lies inside the image and by 0 elsewhere, summed in JAX's order."""
    B, H, W, C = img.shape
    x = _unnormalize(grid[..., 0], W, align_corners).reshape(B, -1)
    y = _unnormalize(grid[..., 1], H, align_corners).reshape(B, -1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = img.reshape(B, H * W, C)
    out = None
    for ix, iy, w in ((x0, y0, wx0 * wy0), (x0 + 1, y0, wx1 * wy0),
                      (x0, y0 + 1, wx0 * wy1), (x0 + 1, y0 + 1, wx1 * wy1)):
        inside = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        t = vals * torch.where(inside, w, torch.zeros_like(w))[..., None]
        out = t if out is None else out + t
    return out.reshape(*grid.shape[:-1], C)


def grid_sample_3d(vol: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = True,
                   round_weights: bool = False) -> torch.Tensor:
    """vol (B, D, H, W, C); grid (B, ..., 3) of (x, y, z) in [-1, 1], x
    indexing W, y H, z D -> (B, ..., C), float32 when vol is bf16 (the
    product with the float32 weights; with ``round_weights`` each tent
    weight is first rounded to vol's type)."""
    B, D, H, W, C = vol.shape
    x = _unnormalize(grid[..., 0], W, align_corners).reshape(B, -1)
    y = _unnormalize(grid[..., 1], H, align_corners).reshape(B, -1)
    z = _unnormalize(grid[..., 2], D, align_corners).reshape(B, -1)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    flat = vol.reshape(B, D * H * W, C)
    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix, iy, iz = x0 + dx, y0 + dy, z0 + dz
                w = ((1.0 - torch.abs(x - ix)) * (1.0 - torch.abs(y - iy))
                     * (1.0 - torch.abs(z - iz)))
                inside = ((ix >= 0) & (ix <= W - 1) & (iy >= 0)
                          & (iy <= H - 1) & (iz >= 0) & (iz <= D - 1))
                idx = ((iz.clamp(0, D - 1) * H + iy.clamp(0, H - 1)) * W
                       + ix.clamp(0, W - 1)).long()
                vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
                w = torch.where(inside, w, torch.zeros_like(w))
                if round_weights:
                    w = w.to(vol.dtype).float()
                t = vals * w[..., None]
                out = t if out is None else out + t
    return out.reshape(*grid.shape[:-1], C)
