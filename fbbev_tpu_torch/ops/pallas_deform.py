"""K10: deformable-attention sampling from precomputed bilinear corners.

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_deform.py:61
pallas_deformable_sample_attend`` (``_kernel`` :42, ``pl.pallas_call``
:102), a drop-in for the single-level deformable sampling + attention sum
(K3's function) that takes the four ``grid_sample`` (align_corners=False)
corners of every sample precomputed: ``idx`` int32 (B, Q*heads*P, 4), the
flat map index clipped into the map, and ``wgt`` f32 (B, Q*heads*P, 4),
tent_x * tent_y * attn, zero for corners outside the map.  Rows are the
samples (q, h, p) in that order.  No path of the JAX package calls it (its
docstring: the model uses the XLA path); it is ported as the op it is.

CUDA kernel (``csrc/msda.cu``, ``fbbev_msda_corners``): K3's kernel
(``msda_kernel``) with the corners read instead of computed: one thread
per (map, query, head) with the head's ``hd`` sums in registers, the map
staged once per persistent block by one bulk copy where it fits shared
memory (:func:`plan_corners`, a sibling of K3's ``plan_msda``), each
point's 16-byte index row and weight row read once.  Where a pair has 8
points and the staged map leaves room, each warp streams its next 32
pairs' corner rows through a two-stage ring in shared memory
(``cp.async``, whole sectors) instead of loading them directly.  Bound on the card: bytes, 85% of them the corner
rows.  The TPU's one-hot matmul is not carried over.

Rounding, as the TPU kernel's (``pallas_deform.py:47-50``): each corner
weight is rounded to the value type; the products are summed in f32.  The
plain version :func:`deformable_sample_attend_corners_plain` does the same
as a gather and a sum.  CPU tensors take it; CUDA tensors launch the
kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from fbbev_tpu_torch.ops import _cuda
from fbbev_tpu_torch.ops.deform_attn import bilinear_corners
from fbbev_tpu_torch.ops.pallas_sample import SMEM_LIMIT, STAGED_THREADS, \
    MsdaPlan, plan_msda

launches = 0

RING_STAGES = 2      # ``msda.cu::kRingStages``
# Where the ring pays, from a sweep of 1 to all the warps that fit against
# direct loads, bf16 maps of 16x44 and 20x50, hd 10 and 8 (H100): at 8
# points a pair from 3 warps on, at 4 points hardly or not at all.
RING_MIN_WARPS = 3
RING_POINTS = 8


def ring_stage_bytes(P: int) -> int:
    """A ring stage: 32 pairs' index and weight rows, each pair's P rows
    padded by 16 bytes (``msda.cu::ring_stage``)."""
    return 2 * 32 * (16 * P + 16)


@functools.lru_cache(maxsize=64)
def plan_corners(B: int, HW: int, heads: int, hd: int, Q: int, P: int,
                 dtype: torch.dtype, sms: int = 132,
                 ring: bool = True) -> MsdaPlan:
    """K3's plan at these shapes (:func:`pallas_sample.plan_msda`; it
    raises on a type or (hd, P) the kernel does not take); with ``ring``,
    a staged map and :data:`RING_POINTS` points a pair, as many warps a
    block (up to 16) as have room for their ring stages beside the map, if
    that is at least :data:`RING_MIN_WARPS`; else the rows are loaded
    directly."""
    base = plan_msda(B, HW, heads, hd, Q, P, dtype, sms)
    if not (ring and base.staged and P == RING_POINTS):
        return base
    per_warp = RING_STAGES * ring_stage_bytes(P)
    w = min((SMEM_LIMIT - base.smem) // per_warp, STAGED_THREADS // 32)
    if w < RING_MIN_WARPS:
        return base
    bpm = max(1, min(sms // max(B, 1), -(-Q * heads // (32 * w))))
    return MsdaPlan(True, 32 * w, bpm, B * bpm, base.smem + w * per_warp,
                    ring=True)


def corners(loc: torch.Tensor, attn: torch.Tensor, H: int, W: int):
    """``idx`` int32 and ``wgt`` f32, both (B, Q*heads*P, 4), of locations
    ``loc`` (B, Q, heads, P, 2) in [0, 1] and weights ``attn`` (B, Q,
    heads, P): the JAX wrapper's ``_bilinear_corners`` stack with the
    attention weight folded into each corner weight in f32."""
    B = loc.shape[0]
    pairs = list(bilinear_corners(loc.float(), H, W))
    idx = torch.stack([i for i, _ in pairs], -1).to(torch.int32)
    wgt = torch.stack([w for _, w in pairs], -1) * attn.float()[..., None]
    return idx.reshape(B, -1, 4), wgt.reshape(B, -1, 4)


def deformable_sample_attend_corners_plain(value: torch.Tensor,
                                           idx: torch.Tensor,
                                           wgt: torch.Tensor, heads: int,
                                           P: int) -> torch.Tensor:
    """Plain version: value (B, HW, heads, hd); idx, wgt (B, Q*heads*P, 4)
    -> (B, Q, heads*hd) f32, each weight rounded to the value type, the
    products of every head's P samples and 4 corners summed in f32."""
    B, HW, _, hd = value.shape
    Q = idx.shape[1] // (heads * P)
    vh = value.permute(0, 2, 1, 3)                     # (B, heads, HW, hd)
    ii = idx.long().reshape(B, Q, heads, P * 4).permute(0, 2, 1, 3)
    g = torch.gather(vh, 2, ii.reshape(B, heads, Q * P * 4, 1).expand(
        -1, -1, -1, hd)).float().reshape(B, heads, Q, P * 4, hd)
    w = wgt.to(value.dtype).float().reshape(B, Q, heads, P * 4)
    out = (w.permute(0, 2, 1, 3)[..., None] * g).sum(3)
    return out.permute(0, 2, 1, 3).reshape(B, Q, heads * hd)


def _launch(value: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
            heads: int, P: int, out: torch.Tensor, plan: MsdaPlan) -> int:
    """Launch the kernel under ``plan``: value, idx, wgt and out
    contiguous and 16-byte aligned on the card, checked by the caller.
    Returns the ``cudaError_t``."""
    B, HW, _, hd = value.shape
    Q = idx.shape[1] // (heads * P)
    return _cuda.entry("msda", "fbbev_msda_corners", 4, 12)(
        value.data_ptr(), idx.data_ptr(), wgt.data_ptr(), out.data_ptr(),
        int(value.dtype == torch.bfloat16), B, HW, Q, heads, P, hd,
        int(plan.staged), int(plan.ring), plan.threads, plan.blocks_per_map,
        plan.smem, _cuda.stream_ptr(value))


def deformable_sample_attend_corners(value: torch.Tensor, idx: torch.Tensor,
                                     wgt: torch.Tensor, heads: int,
                                     P: int) -> torch.Tensor:
    """The kernel entry; shapes as :func:`deformable_sample_attend_
    corners_plain`.  CUDA tensors launch the kernel (value bf16 or f32,
    (hd, P) in ``pallas_sample.MSDA_SHAPES``, idx int32 in [0, HW), wgt
    f32); CPU tensors take the plain version.  Raises ``RuntimeError``
    when grad mode is on and an input requires grad (no backward)."""
    _cuda.refuse_grad("deformable_sample_attend_corners (K10)", value, wgt)
    if not value.is_cuda:
        return deformable_sample_attend_corners_plain(value, idx, wgt, heads,
                                                      P)
    global launches
    if value.dim() != 4 or value.shape[2] != heads:
        raise ValueError(f"value {tuple(value.shape)}, heads {heads}")
    B, HW, _, hd = value.shape
    N = idx.shape[1] if idx.dim() == 3 else -1
    if idx.shape != (B, N, 4) or wgt.shape != (B, N, 4) \
            or N % (heads * P):
        raise ValueError(f"idx {tuple(idx.shape)} wgt {tuple(wgt.shape)} "
                         f"for B={B}, heads={heads}, P={P}")
    if idx.dtype != torch.int32 or wgt.dtype != torch.float32:
        raise ValueError(f"dtypes idx {idx.dtype} wgt {wgt.dtype}")
    if not (idx.is_cuda and wgt.is_cuda):
        raise ValueError("value, idx and wgt must be on the card")
    Q = N // (heads * P)
    plan = plan_corners(B, HW, heads, hd, Q, P, value.dtype,
                        _cuda.sm_count(value.device))
    # the kernel's 16-byte loads: a view that starts off the 16-byte grid
    # is copied
    value, idx, wgt = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                       else t.clone(memory_format=torch.contiguous_format)
                       for t in (value, idx, wgt))
    out = torch.empty(B, Q, heads * hd, dtype=torch.float32,
                      device=value.device)
    _cuda.check(_launch(value, idx, wgt, heads, P, out, plan),
                "msda_corners")
    launches += 1
    return out


def pallas_deformable_sample_attend(value: torch.Tensor,
                                    spatial_shape: Tuple[int, int],
                                    loc: torch.Tensor,
                                    attn: torch.Tensor) -> torch.Tensor:
    """The JAX drop-in: value (B, H*W, heads, hd); loc (B, Q, heads, P, 2)
    in [0, 1]; attn (B, Q, heads, P) -> (B, Q, heads*hd) f32.  Builds the
    corners with :func:`corners` and calls
    :func:`deformable_sample_attend_corners`."""
    H, W = spatial_shape
    if value.shape[1] != H * W:
        raise ValueError(f"value {tuple(value.shape)} for map {H}x{W}")
    idx, wgt = corners(loc, attn, H, W)
    return deformable_sample_attend_corners(value, idx, wgt, loc.shape[2],
                                            loc.shape[3])
