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

CUDA kernel (``csrc/msda.cu``, ``fbbev_msda_corners``): K3's gather, one
thread per (map, query, channel), each sample's four corners read as one
16-byte index row and one 16-byte weight row.  The TPU's one-hot matmul is
not carried over.  Bound on the card: bytes (value map, corner rows and
output once).

Rounding, as the TPU kernel's (``pallas_deform.py:47-50``): each corner
weight is rounded to the value type; the products are summed in f32.  The
plain version :func:`deformable_sample_attend_corners_plain` does the same
as a gather and a sum.  CPU tensors take it; CUDA tensors launch the
kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fbbev_tpu_torch.ops import _cuda
from fbbev_tpu_torch.ops.deform_attn import bilinear_corners

launches = 0


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


def deformable_sample_attend_corners(value: torch.Tensor, idx: torch.Tensor,
                                     wgt: torch.Tensor, heads: int,
                                     P: int) -> torch.Tensor:
    """The kernel entry; shapes as :func:`deformable_sample_attend_
    corners_plain`.  CUDA tensors launch the kernel (value bf16 or f32,
    idx int32 in [0, HW), wgt f32); CPU tensors take the plain version.
    Raises ``RuntimeError`` when grad mode is on and an input requires
    grad (no backward)."""
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
    if value.dtype not in (torch.bfloat16, torch.float32) \
            or idx.dtype != torch.int32 or wgt.dtype != torch.float32:
        raise ValueError(f"dtypes value {value.dtype} idx {idx.dtype} wgt "
                         f"{wgt.dtype}")
    if not (idx.is_cuda and wgt.is_cuda):
        raise ValueError("value, idx and wgt must be on the card")
    Q = N // (heads * P)
    value, idx, wgt = value.contiguous(), idx.contiguous(), wgt.contiguous()
    out = torch.empty(B, Q, heads * hd, dtype=torch.float32,
                      device=value.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.lib("msda").fbbev_msda_corners
    fn.argtypes = [vp, vp, vp, vp] + [ci] * 7 + [vp]
    fn.restype = ci
    _cuda.check(fn(value.data_ptr(), idx.data_ptr(), wgt.data_ptr(),
                   out.data_ptr(), int(value.dtype == torch.bfloat16), B, HW,
                   Q, heads, P, hd, _cuda.stream_ptr(value)), "msda_corners")
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
