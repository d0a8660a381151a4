"""K3: deformable-attention sampling (single level, per-head weighted sum).

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_sample.py:165
deformable_sample_attend_pallas`` (``_attend`` :113, ``pl.pallas_call``
:139).  Function: zero-padded bilinear sampling (``grid_sample``
align_corners=False) of a ``(H*W, heads, hd)`` value map at ``P`` points
per (query, head), summed with the attention weights -> ``(Q, heads*hd)``
f32.

CUDA kernel (``csrc/msda.cu``): mmcv's gather formulation, one thread per
(map, query, channel) looping over points and their four corners.  Bound
on the card: bytes (value map, locations and weights read once, output
written once): about 8 us at the cross-attention shapes and 3 us at the
self-attention shapes on an H100 SXM (``chip_smoke.py``).  The TPU's
VMEM one-hot matmul is not carried over.  Both the spatial
cross-attention and, on the card, the BEV self-attention
(queries are the value grid, one level) run this kernel; inside the
self-attention's locality contract it is the function the JAX package's
grid-tiled path computes.

Rounding: the TPU kernel rounds the combined weight tent_x * tent_y * attn
to the value dtype before its f32-accumulated product; the kernel and the
plain version :func:`deformable_sample_attend_plain`
(``ops/deform_attn.py::deformable_sample_attend``) do the same.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fbbev_tpu_torch.ops import _cuda
# the plain version is the differentiable gather form training uses
from fbbev_tpu_torch.ops.deform_attn import \
    deformable_sample_attend as deformable_sample_attend_plain

launches = 0           # spatial cross-attention launches
selfattn_launches = 0  # BEV self-attention launches (``selfattn=True``)


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
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"value dtype {value.dtype}")
    value = value.contiguous()
    loc = loc.float().contiguous()
    attn = attn.float().contiguous()
    if not (loc.is_cuda and attn.is_cuda):
        raise ValueError("value, loc and attn must be on the card")
    out = torch.empty(B, Q, heads * hd, dtype=torch.float32,
                      device=value.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.lib("msda").fbbev_msda
    fn.argtypes = [vp, vp, vp, vp] + [ci] * 8 + [vp]
    fn.restype = ci
    _cuda.check(fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                   out.data_ptr(), int(value.dtype == torch.bfloat16), B, H,
                   W, Q, heads, P, hd, _cuda.stream_ptr(value)), "msda")
    if selfattn:
        selfattn_launches += 1
    else:
        launches += 1
    return out
