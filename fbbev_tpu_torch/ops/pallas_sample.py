"""K3: deformable-attention sampling (single level, per-head weighted sum).

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_sample.py:165
deformable_sample_attend_pallas`` (``_attend`` :113, ``pl.pallas_call``
:139).  Function: zero-padded bilinear sampling (``grid_sample``
align_corners=False) of a ``(H*W, heads, hd)`` value map at ``P`` points
per (query, head), summed with the attention weights -> ``(Q, heads*hd)``
f32.  Both the spatial cross-attention and, on the card, the BEV
self-attention (K4, ``fbbev_tpu/ops/pallas_selfattn.py:198``: queries are
the value grid, one level) run this kernel; inside the self-attention's
locality contract it is the function the JAX package's grid-tiled path
computes.

CUDA kernel (``csrc/msda.cu::msda_kernel``): one thread per (map, query,
head) with the head's ``hd`` sums in registers.  It reads its P locations
and weights with 16-byte loads, computes each point's four corner weights
once for all channels, and reads each corner's head row as bf16 pairs.
When a whole map fits the plan's shared memory (the cross-attention's
16x44 map, 112,640 bytes in bf16), persistent blocks are given one map
each and copy it into shared memory once (one ``cp.async.bulk``) before
walking their tiles of its queries; a larger map (the self-attention's
100x100, 1.6 MB, held in L2) is read from global memory.
:func:`plan_msda` is the plan in Python; the C entry refuses a
shared-memory byte count other than the map's.  Bound on the card: bytes
(value map, locations and weights read once, output written once): about
8 us at the cross-attention shapes and 3 us at the self-attention shapes
on an H100 SXM (``chip_smoke.py``).  The TPU's VMEM one-hot matmul is not
carried over.

Rounding: the TPU kernel rounds the combined weight tent_x * tent_y * attn
to the value dtype before its f32-accumulated product; the kernel and the
plain version :func:`deformable_sample_attend_plain`
(``ops/deform_attn.py::deformable_sample_attend``) do the same.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from fbbev_tpu_torch.ops import _cuda
# the plain version is the differentiable gather form training uses
from fbbev_tpu_torch.ops.deform_attn import \
    deformable_sample_attend as deformable_sample_attend_plain

launches = 0           # spatial cross-attention launches
selfattn_launches = 0  # BEV self-attention launches (``selfattn=True``)

SMEM_LIMIT = 232448  # shared memory a block may take on an H100
# (hd, P) the kernel is instantiated for (``msda.cu::launch``): the
# flagship's and the small config's heads, at the cross-attention's and
# the self-attention's points
MSDA_SHAPES = ((10, 8), (10, 4), (8, 8), (8, 4))
STAGED_THREADS = 512  # a persistent block of a staged map
GLOBAL_THREADS = 128  # a block of the global-row path (~5 a SM at K4)


class MsdaPlan(NamedTuple):
    """The kernel's plan: whether each map is staged in shared memory,
    threads a block, persistent blocks per map (staged), the grid and the
    shared-memory bytes (the map's + 16 for its mbarrier, or 0); for K10
    (``ops/pallas_deform.py::plan_corners``) whether the corner rows go
    through each warp's ring, whose stages ``smem`` then counts too."""
    staged: bool
    threads: int
    blocks_per_map: int
    grid: int
    smem: int
    ring: bool = False


@functools.lru_cache(maxsize=64)
def plan_msda(B: int, HW: int, heads: int, hd: int, Q: int, P: int,
              dtype: torch.dtype, sms: int = 132) -> MsdaPlan:
    """The plan of K3 at these shapes on a card of ``sms`` SMs: a map of
    ``HW * heads * hd`` values that fits a block's shared memory (with its
    mbarrier) is staged, by ``max(1, sms // B)`` blocks each, else its
    rows are read from global memory.  Raises on a type or (hd, P) the
    kernel does not take."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA msda takes bf16 or f32, not {dtype}")
    if (hd, P) not in MSDA_SHAPES:
        raise ValueError(f"the CUDA msda takes (hd, P) in {MSDA_SHAPES}, "
                         f"not {(hd, P)}")
    nbytes = HW * heads * hd * (2 if dtype == torch.bfloat16 else 4)
    pairs = Q * heads
    if nbytes % 16 == 0 and nbytes + 16 <= SMEM_LIMIT:
        tiles = max(1, -(-pairs // STAGED_THREADS))
        bpm = max(1, min(sms // max(B, 1), tiles))
        return MsdaPlan(True, STAGED_THREADS, bpm, B * bpm, nbytes + 16)
    return MsdaPlan(False, GLOBAL_THREADS, 1,
                    -(-B * pairs // GLOBAL_THREADS), 0)


def deformable_sample_attend(value: torch.Tensor,
                             spatial_shape: Tuple[int, int],
                             loc: torch.Tensor,
                             attn: torch.Tensor,
                             selfattn: bool = False) -> torch.Tensor:
    """Shapes as :func:`deformable_sample_attend_plain`.  CUDA tensors
    launch the kernel (value bf16 or f32); CPU tensors take the plain
    version.  ``selfattn`` marks the BEV self-attention's call, counted in
    ``selfattn_launches`` instead of ``launches``.  Raises
    ``RuntimeError`` when grad mode is on and an input requires grad:
    training samples through the plain version itself."""
    _cuda.refuse_grad("deformable_sample_attend (K3)", value, loc, attn)
    if not value.is_cuda:
        return deformable_sample_attend_plain(value, spatial_shape, loc,
                                              attn)
    global launches, selfattn_launches
    B, HW, heads, hd = value.shape
    H, W = spatial_shape
    Q, P = loc.shape[1], loc.shape[3]
    if HW != H * W or loc.shape != (B, Q, heads, P, 2) \
            or attn.shape != (B, Q, heads, P):
        raise ValueError(f"shapes {value.shape} {loc.shape} {attn.shape}")
    plan = plan_msda(B, HW, heads, hd, Q, P, value.dtype,
                     _cuda.sm_count(value.device))
    if not (loc.is_cuda and attn.is_cuda):
        raise ValueError("value, loc and attn must be on the card")
    # the kernel's 16-byte loads: a view that starts off the 16-byte grid
    # is copied
    value, loc, attn = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                        else t.clone(memory_format=torch.contiguous_format)
                        for t in (value, loc.float(), attn.float()))
    out = torch.empty(B, Q, heads * hd, dtype=torch.float32,
                      device=value.device)
    _cuda.check(_cuda.entry("msda", "fbbev_msda", 4, 12)(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
        int(value.dtype == torch.bfloat16), B, H, W, Q, heads, P, hd,
        int(plan.staged), plan.threads, plan.blocks_per_map, plan.smem,
        _cuda.stream_ptr(value)), "msda")
    if selfattn:
        selfattn_launches += 1
    else:
        launches += 1
    return out
