"""K5: affine trilinear warp of an age-ordered history volume.

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_warp.py:190
warp_affine_3d`` (``_warp_kernel``, ``pl.pallas_call`` :234), the warp of
the JAX package's age-ordered history fallback (``fbocc.py:445-453``, with
``out_zyx=False``).  Function: each output voxel (y, x, z) samples the
``(B, Z, Y, X, C)`` volume at the source index coordinates the
``(B, 4, 4)`` flow gives it (align_corners=True units), trilinearly, zero
outside the volume; the result is ``(B, Y, X, Z, C)``.

CUDA kernel (``csrc/fuse_warp.cu::warp_box_kernel``).  Bound on the card:
bytes (the volume read once and the warped volume written once, 2 x 205
MB in bf16 at the flagship): about 0.12 ms on an H100 SXM.  Each source
row is a corner of about 8 output voxels, so a gather reads it 8 times
over; the kernel's boxes read it 2.4 times (the box over the tile at the
default plan), each time as part of one bulk copy.  Persistent blocks walk tasks: a tile of TY x TX
output columns over the whole Z, crossed with a group of 32-byte channel
chunks (16 bf16 or 8 f32).  A task's source box -- the extremes of the
affine map over the tile's corner voxels, one guard cell each way --
comes from the flow on the device; if it fits the plan's box (TY + 2
margin) x (TX + 2 margin) x Z, one 5-D TMA box per chunk copies it into
shared memory through a ring of mbarrier-guarded stages, filled ahead of
the compute, and each voxel's 8 corners are read from there by two
threads (a 16-byte half each, whole 32-byte sectors stored), which keep
the voxel's corner weights and box cells in registers across the group.
A tile whose box does not fit (a large rotation or translation) reads the
volume directly in the same kernel.  The choice is made per tile on the
device: no host read of the flow.  :func:`plan_warp` is the plan in
Python (tile, margin, stages, threads, group, shared-memory bytes,
grid); the C entry refuses a byte count that differs from the kernel's.

Arithmetic: the tent weight rounded to the volume's type, as the TPU
kernel's one-hot matrix is, corners 0..7 summed into f32 in order, a
corner outside the volume read at its clamped cell with weight 0 -- the
operations of K1's plain warp stage
(``pallas_fuse_warp.fuse_warp_plain`` run as one slot), to which the
kernel is bit-identical.  The TPU kernel is exact inside its locality
contract (``pallas_warp.py:27-35``) and clamps beyond it; the kernel here
is exact everywhere.

The plain version is the JAX package's XLA fallback: ``grid_sample_3d`` on
the flow's normalised grid (``geometry.flow_grid``), f32 weights, rounded
to the volume's type at the end.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from fbbev_tpu_torch import geometry
from fbbev_tpu_torch.ops import _cuda
from fbbev_tpu_torch.ops.grid_sample import grid_sample_3d

launches = 0

CELL = 32          # bytes of a voxel's channel chunk in the box
MAX_BOX_Z = 8      # the box's depth cap: a deeper volume falls back
SMEM_LIMIT = 232448  # shared memory a block may take on an H100
# (TY, TX, margin, stages, threads, group) the kernel is instantiated for
# (``fuse_warp.cu::launch_plan``); the first is the default
WARP_PLANS = ((4, 20, 2, 4, 640, 4), (8, 16, 2, 3, 512, 2),
              (4, 20, 2, 4, 640, 8))


class WarpPlan(NamedTuple):
    """The kernel's plan: output tile ``TY`` x ``TX`` columns (all Z), box
    margin, ring stages, threads a block, chunks a task (``group``: a
    thread keeps its voxels' corner table for them), channels a chunk
    ``cc``, the box (BZ, BY, BX) in cells, its bytes, the shared-memory
    bytes of ``fuse_warp.cu::box_smem``, the tasks and the persistent
    grid."""
    TY: int
    TX: int
    margin: int
    stages: int
    threads: int
    group: int
    cc: int
    box: Tuple[int, int, int]
    stage_bytes: int
    smem: int
    tasks: int
    grid: int


@functools.lru_cache(maxsize=64)
def plan_warp(B: int, Z: int, Y: int, X: int, C: int, dtype: torch.dtype,
              sms: int = 132, plan: Optional[Tuple[int, ...]] = None
              ) -> WarpPlan:
    """The plan of K5 at these shapes: ``plan`` (one of
    :data:`WARP_PLANS`, the first by default) on a card of ``sms`` SMs.
    Raises on a type, width or plan the kernel does not take."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA warp_affine takes bf16 or f32, not "
                         f"{dtype}")
    esize = 2 if dtype == torch.bfloat16 else 4
    cc = CELL // esize
    if C % cc:
        raise ValueError(f"the CUDA warp_affine takes C a multiple of {cc} "
                         f"in {dtype}, not {C}")
    plan = WARP_PLANS[0] if plan is None else tuple(plan)
    if plan not in WARP_PLANS:
        raise ValueError(f"the CUDA warp_affine takes a plan in "
                         f"{WARP_PLANS}, not {plan}")
    ty, tx, m, st, nt, grp = plan
    box = (min(Z, MAX_BOX_Z), ty + 2 * m, tx + 2 * m)
    stage = box[0] * box[1] * box[2] * CELL
    smem = st * stage + 8 * st + 128
    if st * MAX_BOX_Z * box[1] * box[2] * CELL + 8 * st + 128 > SMEM_LIMIT:
        raise ValueError(f"warp_affine plan {plan} takes more than "
                         f"{SMEM_LIMIT} bytes of shared memory")
    tasks = B * -(-Y // ty) * -(-X // tx) * -(-(C // cc) // grp)
    return WarpPlan(ty, tx, m, st, nt, grp, cc, box, stage, smem, tasks,
                    max(1, min(tasks, sms)))

TILE = 10     # the TPU kernel's output tile edge
SLAB_X = 32   # its source slab width
ZBAND = 3     # its z band


def supports(shape: Sequence[int]) -> bool:
    """The JAX gate (``pallas_warp.py:266-270``) on a (B, D, H, W, C)
    volume shape."""
    _, D, H, W, C = shape
    return (H % TILE == 0 and W % TILE == 0 and H >= SLAB_X
            and W >= SLAB_X and C % 128 == 0 and D >= ZBAND)


def warp_affine_3d_plain(vol: torch.Tensor, mat: torch.Tensor,
                         round_weights: bool = False) -> torch.Tensor:
    """Plain version; arguments and result as :func:`warp_affine_3d`.
    ``round_weights``: each tent weight rounded to vol's type first, as
    the kernel and the JAX package's eval warps (its TPU kernel, its tiled
    XLA fallback) round it; its training warp does not."""
    _, D, H, W, _ = vol.shape
    grid = geometry.flow_grid(mat.float(), (D, H, W))
    return grid_sample_3d(vol, grid,
                          round_weights=round_weights).to(vol.dtype)


def warp_affine_3d(vol: torch.Tensor, mat: torch.Tensor,
                   plan: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Warp ``vol`` (B, D, H, W, C) by the flow ``mat`` (B, 4, 4), output
    (x, y, z) index coordinates to source ones, into (B, H, W, D, C) in
    ``vol``'s type.  CUDA tensors launch the kernel (bf16 with C a
    multiple of 16 or f32 with C a multiple of 8; ``plan`` one of
    :data:`WARP_PLANS`, the default if None) and raise on inputs it does
    not take; CPU tensors take the plain version.  No backward."""
    _cuda.refuse_grad("warp_affine_3d (K5)", vol, mat)
    if not vol.is_cuda:
        return warp_affine_3d_plain(vol, mat)
    global launches
    B, D, H, W, C = vol.shape
    if tuple(mat.shape) != (B, 4, 4):
        raise ValueError(f"shapes vol {tuple(vol.shape)} mat "
                         f"{tuple(mat.shape)}")
    if not mat.is_cuda:
        raise ValueError("vol and mat must be on the card")
    p = plan_warp(B, D, H, W, C, vol.dtype, _cuda.sm_count(vol.device),
                  plan)
    vol = vol.contiguous()
    mrows = mat[:, :3, :].float().reshape(B, 12).contiguous()
    out = torch.empty(B, H, W, D, C, dtype=vol.dtype, device=vol.device)
    if vol.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("warp_affine_3d takes a 16-byte aligned volume")
    _cuda.check(_cuda.entry("fuse_warp", "fbbev_warp_affine", 3, 14)(
        vol.data_ptr(), mrows.data_ptr(), out.data_ptr(),
        int(vol.dtype == torch.bfloat16), B, D, H, W, C, p.TY, p.TX,
        p.margin, p.stages, p.threads, p.group, p.grid, p.smem,
        _cuda.stream_ptr(vol)), "warp_affine")
    launches += 1
    return out
