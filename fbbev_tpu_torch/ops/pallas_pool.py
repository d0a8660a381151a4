"""K2: fixed-rig LSS voxel pooling (the "splat") on a host-built plan.

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_pool.py:207
lss_voxel_pool_planned`` (``_pool_slabs`` :161, ``pl.pallas_call`` :169).
Function: ``out[rank[p], c] += depth[p] * feat[pixel(p), c]`` over every
valid frustum point of a fixed rig, output ``(B, Y, X, Z, C)`` f32; the
features may be bf16, widened exactly to f32 (the JAX wrapper's cast).

CUDA kernel (``csrc/bev_pool.cu``): one pass that writes every output row
once, zeros included, so the output is allocated with ``torch.empty``.
The host sorts the valid points by output row once per rig
(:func:`plan_pool`): a row pointer over all ``B*ny*nx*nz`` rows, the
sorted points as flat depth indices (the kernel derives each feature row
from it), and tiles of consecutive rows (at most :data:`TILE_ROWS` rows
and :data:`TILE_POINTS` points), walked heaviest first.  One warp walks a
tile with its lanes over groups of 4 channels, 16-byte loads and stores,
four feature rows in flight before it sums them in point order, and
writes each row once; a row of more points than a tile takes is walked
by a whole block, eight ranges of its points added in order.  Bound on
the card: bytes (the output, 25.6 MB of the ~30 MB at the flagship,
written once; the depth and feature tables read once), about 9 us on an
H100 SXM (3.35 TB/s), as ``chip_smoke.py`` computes it; the feature-row
gathers (68 MB from L2 in f32) and each point's two dependent loads make
the number of loads in flight what sets its time.  The TPU's one-hot slab
blocking is not carried over: the H100 gathers rows at full speed.

Plain version: :func:`lss_voxel_pool_precomputed` (``ops/bev_pool.py``),
the ``index_add`` scatter of the JAX package's ``ops/bev_pool.py:180``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from fbbev_tpu_torch import host_lib
from fbbev_tpu_torch.ops import _cuda
from fbbev_tpu_torch.ops.bev_pool import lss_voxel_pool_precomputed

launches = 0

# the plan's tiles: at most TILE_ROWS consecutive rows (31 at most: a
# warp's lanes hold their row starts) and TILE_POINTS points, unless one
# row holds more (``chip_smoke.py --pool`` times the alternatives)
TILE_ROWS = 16
TILE_POINTS = 64
MAX_C = 128  # a warp's 32 lanes over groups of 4 channels


@dataclass
class PoolPlan:
    """Static per-rig plan.  ``ranks`` (P,) int64 voxel rank per point in
    natural (b, n, d, h, w) order, dump rank = number of voxels (the plain
    version); the rest are the kernel's tables."""
    ranks: torch.Tensor    # (P,) int64
    row_ptr: torch.Tensor  # (B*ny*nx*nz + 1,) int32, rows in (B, Y, X, Z)
    pts: torch.Tensor      # (Pv,) int32 flat depth index, sorted by row
    work: torch.Tensor     # (T,) int32 first row << 5 | rows, heaviest first
    n_long: int            # the first n_long tiles: a long row each
    grid_size: Tuple[int, int, int]  # (nx, ny, nz)
    batch: int
    D: int                 # depth bins
    NR: int                # pixels of a camera's feature map (fH * fW)

    def to(self, device) -> "PoolPlan":
        return PoolPlan(self.ranks.to(device), self.row_ptr.to(device),
                        self.pts.to(device), self.work.to(device),
                        self.n_long, self.grid_size, self.batch, self.D,
                        self.NR)


def check_channels(C: int) -> None:
    """Raise unless the kernel takes ``C`` channels: a multiple of 4, at
    most :data:`MAX_C`."""
    if not (0 < C <= MAX_C and C % 4 == 0):
        raise ValueError(f"K2 takes C a multiple of 4 up to {MAX_C}, not "
                         f"{C}")


def plan_tiles(counts: np.ndarray, rows: int = TILE_ROWS,
               points: int = TILE_POINTS) -> Tuple[np.ndarray, int]:
    """Cut rows holding ``counts`` points into tiles of consecutive rows:
    at most ``rows`` rows and ``points`` points each, a row holding more
    alone (a long row).  Returns the tiles as ``first row << 5 | rows``
    (T,) int32 by descending points (the long rows first), and the number
    of long rows."""
    if not 1 <= rows <= 31:
        raise ValueError(f"a tile holds 1 to 31 rows, not {rows}")
    counts = np.asarray(counts, np.int64)
    if counts.size >= 1 << 26:
        raise ValueError(f"K2's tiles take fewer than 2^26 rows, not "
                         f"{counts.size}")
    starts, n, k = [0], 0, 0
    for r, c in enumerate(counts.tolist()):
        if k == rows or (k and n + c > points):
            starts.append(r)
            n = k = 0
        n, k = n + c, k + 1
    starts = np.asarray(starts + [counts.size], np.int64)
    npts = np.diff(np.concatenate([[0], np.cumsum(counts)])[starts])
    order = np.argsort(-npts, kind="stable")
    work = (starts[:-1] << 5) | np.diff(starts)
    return work[order].astype(np.int32), int((npts > points).sum())


def plan_pool(ranks_bev: np.ndarray, B: int, N: int, D: int, fH: int,
              fW: int, grid_size: Sequence[int], rows: int = TILE_ROWS,
              points: int = TILE_POINTS) -> PoolPlan:
    """Sort the valid points of a fixed rig by output row and build the
    kernel's tables.  ``ranks_bev``: (P,) int32 in natural (b, n, d, h, w)
    point order with dump rank ``B*nx*ny*nz`` for invalid points (rank
    ``b*per + z*ny*nx + y*nx + x``; the output row is ``((b*ny + y)*nx +
    x)*nz + z``)."""
    nx, ny, nz = (int(g) for g in grid_size)
    ranks = np.asarray(ranks_bev, np.int64)
    P = ranks.size
    assert P == B * N * D * fH * fW, (P, (B, N, D, fH, fW))
    per = nx * ny * nz
    if P >= 1 << 31:
        raise ValueError(f"K2's int32 tables take fewer than 2^31 points, "
                         f"not {P}")
    valid = np.flatnonzero(ranks < B * per)
    r = ranks[valid]
    b, rem = r // per, r % per
    z, y, x = rem // (nx * ny), (rem // nx) % ny, rem % nx
    out_row = ((b * ny + y) * nx + x) * nz + z
    order, srows, starts, lengths = host_lib.sort_ranks_intervals(
        out_row.astype(np.int32))
    counts = np.zeros(B * per, np.int64)
    counts[srows[starts]] = lengths
    work, n_long = plan_tiles(counts, rows, points)
    as_t = (lambda a, dt=torch.int32: torch.from_numpy(
        np.ascontiguousarray(a)).to(dt))
    return PoolPlan(
        ranks=as_t(ranks, torch.int64),
        row_ptr=as_t(np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int32)),
        pts=as_t(valid[order].astype(np.int32)), work=as_t(work),
        n_long=n_long, grid_size=(nx, ny, nz), batch=B, D=D, NR=fH * fW)


def _launch(plan: PoolPlan, depth: torch.Tensor, feat: torch.Tensor,
            out: torch.Tensor) -> int:
    """Launch the kernel into ``out`` (B, Y, X, Z, C) f32, every row of
    which it writes: depth, feat and out contiguous on the card, checked
    by the caller.  Returns the ``cudaError_t``."""
    C = feat.shape[-1]
    check_channels(C)
    return _cuda.entry("bev_pool", "fbbev_bev_pool", 6, 6)(
        depth.data_ptr(), feat.data_ptr(), plan.row_ptr.data_ptr(),
        plan.pts.data_ptr(), plan.work.data_ptr(), out.data_ptr(),
        int(feat.dtype == torch.bfloat16), plan.work.numel(), plan.n_long,
        C, plan.D * plan.NR, plan.NR, _cuda.stream_ptr(depth))


def lss_voxel_pool_planned(plan: PoolPlan, depth: torch.Tensor,
                           feat: torch.Tensor) -> torch.Tensor:
    """``depth (B, N, D, fH, fW)`` f32, ``feat (B, N, fH, fW, C)`` f32 or
    bf16 -> ``(B, Y, X, Z, C)`` f32 (``feat`` widened exactly).  CUDA
    tensors launch the kernel; CPU tensors take the plain version.
    Raises ``RuntimeError`` when grad mode is on and an input requires
    grad: training pools with
    :func:`fbbev_tpu_torch.ops.bev_pool.lss_voxel_pool`."""
    _cuda.refuse_grad("lss_voxel_pool_planned (K2)", depth, feat)
    if not depth.is_cuda:
        return lss_voxel_pool_precomputed(plan.ranks, depth, feat.float(),
                                          plan.grid_size)
    global launches
    nx, ny, nz = plan.grid_size
    B, N, D, fH, fW = depth.shape
    C = feat.shape[-1]
    check_channels(C)
    if (B, D, fH * fW) != (plan.batch, plan.D, plan.NR) \
            or depth.numel() != plan.ranks.numel() \
            or feat.shape != (B, N, fH, fW, C):
        raise ValueError(f"depth {tuple(depth.shape)} feat "
                         f"{tuple(feat.shape)} for the plan's B "
                         f"{plan.batch}, D {plan.D}, {plan.NR} pixels, "
                         f"{plan.ranks.numel()} points")
    if depth.dtype != torch.float32 or not depth.is_contiguous():
        raise ValueError("depth must be contiguous float32")
    if feat.dtype not in (torch.float32, torch.bfloat16) \
            or not feat.is_contiguous():
        raise ValueError("feat must be contiguous float32 or bfloat16")
    if not (feat.is_cuda and plan.pts.is_cuda):
        raise ValueError("depth, feat and the plan must be on the card")
    out = torch.empty(B, ny, nx, nz, C, dtype=torch.float32,
                      device=depth.device)
    _cuda.check(_launch(plan, depth, feat, out), "bev_pool")
    launches += 1
    return out
