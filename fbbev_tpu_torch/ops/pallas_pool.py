"""K2: fixed-rig LSS voxel pooling (the "splat") on a host-built plan.

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_pool.py:207
lss_voxel_pool_planned`` (``_pool_slabs`` :161, ``pl.pallas_call`` :169).
Function: ``out[rank[p], c] += depth[p] * feat[pixel(p), c]`` over every
valid frustum point of a fixed rig, output ``(B, Y, X, Z, C)`` f32.

CUDA kernel (``csrc/bev_pool.cu``): the BEVPoolv2 interval walk.  The
host sorts the valid points by voxel once per rig (:func:`plan_pool`);
one warp per voxel interval sums ``depth*feat`` with its lanes over
channels and writes the voxel once -- no atomics.  Bound on the card:
bytes (the depth and feature tables read once, the output written once);
the work is a few MFLOP.  At the flagship that is about 9 us on an H100
SXM (3.35 TB/s), as ``chip_smoke.py`` computes it from its rig.  The
TPU's one-hot slab blocking is not carried over: the H100 gathers rows at
full speed.

Plain version: :func:`lss_voxel_pool_precomputed` (``ops/bev_pool.py``),
the ``index_add`` scatter of the JAX package's ``ops/bev_pool.py:180``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from fbbev_tpu_torch import host_lib
from fbbev_tpu_torch.ops import _cuda
from fbbev_tpu_torch.ops.bev_pool import lss_voxel_pool_precomputed

launches = 0


@dataclass
class PoolPlan:
    """Static per-rig plan.  ``ranks`` (P,) int64 voxel rank per point in
    natural (b, n, d, h, w) order, dump rank = number of voxels (plain
    version); the rest are the sorted interval table of the kernel."""
    ranks: torch.Tensor     # (P,) int64
    pt_depth: torch.Tensor  # (Pv,) int32 flat depth index of sorted points
    pt_feat: torch.Tensor   # (Pv,) int32 feature row (b*N + n)*fH*fW + pix
    iv_start: torch.Tensor  # (I,) int32 first sorted point of the interval
    iv_len: torch.Tensor    # (I,) int32 points in the interval
    iv_out: torch.Tensor    # (I,) int32 output row in (B, Y, X, Z) order
    grid_size: Tuple[int, int, int]  # (nx, ny, nz)
    batch: int

    def to(self, device) -> "PoolPlan":
        f = (lambda t: t.to(device))
        return PoolPlan(f(self.ranks), f(self.pt_depth), f(self.pt_feat),
                        f(self.iv_start), f(self.iv_len), f(self.iv_out),
                        self.grid_size, self.batch)


def plan_pool(ranks_bev: np.ndarray, B: int, N: int, D: int, fH: int,
              fW: int, grid_size: Sequence[int]) -> PoolPlan:
    """Sort the valid points of a fixed rig by voxel and cut them into
    intervals.  ``ranks_bev``: (P,) int32 in natural (b, n, d, h, w)
    point order with dump rank ``B*nx*ny*nz`` for invalid points."""
    nx, ny, nz = (int(g) for g in grid_size)
    ranks = np.asarray(ranks_bev, np.int64)
    P = ranks.size
    assert P == B * N * D * fH * fW, (P, (B, N, D, fH, fW))
    NR = fH * fW
    per = nx * ny * nz
    valid = np.flatnonzero(ranks < B * per)
    order, rs, starts, lengths = host_lib.sort_ranks_intervals(
        ranks[valid].astype(np.int32))
    p = valid[order]
    r = rs[starts].astype(np.int64)
    b, rem = r // per, r % per
    z, y, x = rem // (nx * ny), (rem // nx) % ny, rem % nx
    as_t = (lambda a, dt=torch.int32: torch.from_numpy(
        np.ascontiguousarray(a)).to(dt))
    return PoolPlan(
        ranks=as_t(ranks, torch.int64),
        pt_depth=as_t(p.astype(np.int32)),
        pt_feat=as_t(((p // (D * NR)) * NR + p % NR).astype(np.int32)),
        iv_start=as_t(starts), iv_len=as_t(lengths),
        iv_out=as_t((((b * ny + y) * nx + x) * nz + z).astype(np.int32)),
        grid_size=(nx, ny, nz), batch=B)


def lss_voxel_pool_planned(plan: PoolPlan, depth: torch.Tensor,
                           feat: torch.Tensor) -> torch.Tensor:
    """``depth (B, N, D, fH, fW)`` f32, ``feat (B, N, fH, fW, C)`` f32 ->
    ``(B, Y, X, Z, C)`` f32.  CUDA tensors launch the kernel; CPU tensors
    take the plain version.  Raises ``RuntimeError`` when grad mode is on
    and an input requires grad: training pools with
    :func:`fbbev_tpu_torch.ops.bev_pool.lss_voxel_pool`."""
    _cuda.refuse_grad("lss_voxel_pool_planned (K2)", depth, feat)
    if not depth.is_cuda:
        return lss_voxel_pool_precomputed(plan.ranks, depth, feat,
                                          plan.grid_size)
    global launches
    nx, ny, nz = plan.grid_size
    B, C = depth.shape[0], feat.shape[-1]
    for t, name in ((depth, "depth"), (feat, "feat")):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if not (feat.is_cuda and plan.iv_out.is_cuda):
        raise ValueError("depth, feat and the plan must be on the card")
    out = torch.zeros(B, ny, nx, nz, C, dtype=torch.float32,
                      device=depth.device)
    vp = ctypes.c_void_p
    fn = _cuda.lib("bev_pool").fbbev_bev_pool
    fn.argtypes = [vp] * 7 + [ctypes.c_int, ctypes.c_int, vp, vp]
    fn.restype = ctypes.c_int
    _cuda.check(fn(depth.data_ptr(), feat.data_ptr(),
                   plan.pt_depth.data_ptr(), plan.pt_feat.data_ptr(),
                   plan.iv_start.data_ptr(), plan.iv_len.data_ptr(),
                   plan.iv_out.data_ptr(), int(plan.iv_out.numel()), C,
                   out.data_ptr(), _cuda.stream_ptr(depth)), "bev_pool")
    launches += 1
    return out
