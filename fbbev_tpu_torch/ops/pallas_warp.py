"""K5: affine trilinear warp of an age-ordered history volume.

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_warp.py:190
warp_affine_3d`` (``_warp_kernel``, ``pl.pallas_call`` :234), the warp of
the JAX package's age-ordered history fallback (``fbocc.py:445-453``, with
``out_zyx=False``).  Function: each output voxel (y, x, z) samples the
``(B, Z, Y, X, C)`` volume at the source index coordinates the
``(B, 4, 4)`` flow gives it (align_corners=True units), trilinearly, zero
outside the volume; the result is ``(B, Y, X, Z, C)``.

CUDA kernel: K1's warp stage run alone (``csrc/fuse_warp.cu``, its
``kRing`` flag off: no start reset, no new history, no epilogue), launched
as one slot of C channels.  Each lane gathers 16-byte channel vectors of a
corner row; the tent weight is rounded to the volume's type, as the TPU
kernel's one-hot matrix is, and the eight corners summed in f32.  Bound on
the card: bytes (the volume read once and the warped volume written once,
2 x 205 MB in bf16 at the flagship): about 0.12 ms on an H100 SXM.  The
TPU kernel is exact inside its locality contract (``pallas_warp.py:27-35``)
and clamps beyond it; the kernel here is exact everywhere.

The plain version is the JAX package's XLA fallback: ``grid_sample_3d`` on
the flow's normalised grid (``geometry.flow_grid``), f32 weights, rounded
to the volume's type at the end.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from fbbev_tpu_torch import geometry
from fbbev_tpu_torch.ops import _cuda
from fbbev_tpu_torch.ops.grid_sample import grid_sample_3d

launches = 0

TILE = 10     # the TPU kernel's output tile edge
SLAB_X = 32   # its source slab width
ZBAND = 3     # its z band


def supports(shape: Sequence[int]) -> bool:
    """The JAX gate (``pallas_warp.py:266-270``) on a (B, D, H, W, C)
    volume shape."""
    _, D, H, W, C = shape
    return (H % TILE == 0 and W % TILE == 0 and H >= SLAB_X
            and W >= SLAB_X and C % 128 == 0 and D >= ZBAND)


def warp_affine_3d_plain(vol: torch.Tensor, mat: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version; arguments and result as :func:`warp_affine_3d`."""
    _, D, H, W, _ = vol.shape
    grid = geometry.flow_grid(mat.float(), (D, H, W))
    return grid_sample_3d(vol, grid).to(vol.dtype)


def warp_affine_3d(vol: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Warp ``vol`` (B, D, H, W, C) by the flow ``mat`` (B, 4, 4), output
    (x, y, z) index coordinates to source ones, into (B, H, W, D, C) in
    ``vol``'s type.  CUDA tensors launch the kernel (bf16 or f32, C a
    multiple of 8); CPU tensors take the plain version.  No backward."""
    _cuda.refuse_grad("warp_affine_3d (K5)", vol, mat)
    if not vol.is_cuda:
        return warp_affine_3d_plain(vol, mat)
    global launches
    B, D, H, W, C = vol.shape
    if vol.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"vol dtype {vol.dtype}")
    if C % 8 or tuple(mat.shape) != (B, 4, 4):
        raise ValueError(f"shapes vol {tuple(vol.shape)} mat "
                         f"{tuple(mat.shape)}")
    if not mat.is_cuda:
        raise ValueError("vol and mat must be on the card")
    vol = vol.contiguous()
    mrows = mat[:, :3, :].float().reshape(B, 12).contiguous()
    out = torch.empty(B, H, W, D, C, dtype=vol.dtype, device=vol.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.lib("fuse_warp").fbbev_warp_affine
    fn.argtypes = [vp, vp, vp] + [ci] * 6 + [vp]
    fn.restype = ci
    _cuda.check(fn(vol.data_ptr(), mrows.data_ptr(), out.data_ptr(),
                   int(vol.dtype == torch.bfloat16), B, D, H, W, C,
                   _cuda.stream_ptr(vol)), "warp_affine")
    launches += 1
    return out
