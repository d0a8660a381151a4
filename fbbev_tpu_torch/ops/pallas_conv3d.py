"""K6: 3x3x3 stride-1 zero-padded 3D convolution (no backward).

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_conv3d.py:130
conv3d_3x3x3`` (``_kernel`` :77, ``pl.pallas_call`` :157), the eval route
of the stride-1 3x3x3 convs under ``FBBEV_CONV3D=pallas``.  Function:
``y = conv3d(x, w)`` with a 3x3x3 kernel, stride 1, padding 1 (zero), no
dilation; bf16 or f32 in, f32 accumulation, output in x's type.  Like the
TPU kernel it has no backward: the wrapper refuses inputs that require
grad, and training keeps the other routes.

Layout: tensors are the port's ``(B, C, Y, X, Z)`` -- x (B, Cin, Y, X, Z),
w (Cout, Cin, 3, 3, 3) with taps in (dy, dx, dz) order -- and the kernel
reads channels-last memory, the JAX package's (B, Y, X, Z, C): the wrapper
takes ``x.permute(0, 2, 3, 4, 1)`` (free when x is in
``torch.channels_last_3d`` memory format, a copy otherwise) and returns y
as a ``(B, Cout, Y, X, Z)`` view of channels-last storage.  The weights
are relaid out to the JAX package's (3, 3, 3, Cin, Cout).

CUDA kernel (``csrc/conv3d.cu``): a direct implicit GEMM, one block per
(rows x 16 columns x all Z output voxels, 64 output channels), the halo --
z included, zero-filled at the z edges -- and the weights of each
16-channel chunk staged in shared memory, products on WMMA bf16 with f32
accumulation; a CUDA-core f32 kernel for f32 inputs.  Bound on the card:
operations (2 * voxels * 27 * Cin * Cout on the bf16 tensor cores).

The plain version :func:`conv3d_3x3x3_plain` is ``F.conv3d`` in f32
(cuDNN's TF32 off), cast to x's type, as :func:`pallas_conv.
conv3x3_s1_plain` is K7's.  CPU tensors take it; CUDA tensors launch the
kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from fbbev_tpu_torch.ops import _cuda

launches = 0

_SLAB_BUDGET = 8 * 1024 * 1024        # the TPU kernel's VMEM budget
_TILES = (16, 10, 8, 5, 4, 2)         # its candidate BEV tile edges


def _pick_tiles(Y: int, X: int, Z: int, Cin: int, itemsize: int):
    """The TPU kernel's tile choice (``pallas_conv3d.py:49-60``)."""
    for ty in _TILES:
        if Y % ty:
            continue
        for tx in _TILES:
            if X % tx:
                continue
            if 2 * (ty + 2) * (tx + 2) * Z * Cin * itemsize <= _SLAB_BUDGET:
                return ty, tx
    return None


def supports(shape: Sequence[int], cout: int) -> bool:
    """The JAX gate (``pallas_conv3d.py:63-74``) on a channels-last
    (B, Y, X, Z, Cin) shape."""
    if len(shape) != 5:
        return False
    _, Y, X, Z, Cin = shape
    if Cin % 128 and Cin != 64:
        return False
    if cout % 64:
        return False
    if Z < 2 or Z > 32:
        return False
    return _pick_tiles(Y, X, Z, Cin, 2) is not None


def conv3d_3x3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, Cin, Y, X, Z), w (Cout, Cin, 3, 3, 3) ->
    (B, Cout, Y, X, Z) in x's type, f32 accumulation."""
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        y = F.conv3d(x.float(), w.float(), padding=1)
    return y.to(x.dtype)


def conv3d_3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The convolution (no gradient): CUDA tensors launch the kernel (bf16
    or f32; Cin and Cout multiples of 16, 1 <= Z <= 32), CPU tensors take
    the plain version.  Shapes as :func:`conv3d_3x3x3_plain`."""
    _cuda.refuse_grad("conv3d_3x3x3 (K6)", x, w)
    if not x.is_cuda:
        return conv3d_3x3x3_plain(x, w)
    global launches
    B, Cin, Y, X, Z = x.shape
    Cout = w.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x dtype {x.dtype}")
    if tuple(w.shape) != (Cout, Cin, 3, 3, 3):
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if Cin % 16 or Cout % 16 or not 1 <= Z <= 32:
        raise ValueError(f"the kernel needs Cin, Cout multiples of 16 and "
                         f"1 <= Z <= 32: Cin={Cin} Cout={Cout} Z={Z}")
    if not w.is_cuda or w.device != x.device:
        raise ValueError("x and w must be on the same card")
    xh = x.permute(0, 2, 3, 4, 1).contiguous()
    wk = w.to(x.dtype).permute(2, 3, 4, 1, 0).contiguous()
    y = torch.empty(B, Y, X, Z, Cout, dtype=x.dtype, device=x.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.lib("conv3d").fbbev_conv3d
    fn.argtypes = [vp, vp, vp] + [ci] * 7 + [vp]
    fn.restype = ci
    _cuda.check(fn(xh.data_ptr(), wk.data_ptr(), y.data_ptr(),
                   int(x.dtype == torch.bfloat16), B, Y, X, Z, Cin, Cout,
                   _cuda.stream_ptr(x)), "conv3d")
    launches += 1
    return y.permute(0, 4, 1, 2, 3)
