"""K7: 3x3 stride-1 zero-padded 2D convolution, forward and backward.

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_conv.py:67 conv3x3_s1``
(``_kernel`` :51, ``pl.pallas_call`` :90) and its custom VJP (``conv3x3``,
:132-156).  Function: ``y = conv(x, w)`` with a 3x3 kernel, stride 1,
padding 1, no dilation; bf16 or f32 in, f32 accumulation, output in x's
type.

Layout: tensors are PyTorch's logical NCHW -- x (N, Cin, H, W), w (Cout,
Cin, 3, 3) -- and the kernel reads channels-last memory: the wrapper takes
``x.permute(0, 2, 3, 1)`` (free when x is in ``torch.channels_last``
memory format, a copy otherwise) and returns y as an NCHW view of NHWC
storage, i.e. in channels-last memory format.  The weights are relaid out
to the JAX package's (3, 3, Cin, Cout).

CUDA kernel (``csrc/conv3x3.cu``): a direct implicit GEMM, one block per
(8 x 16 output pixels, 64 output channels), the input halo and weights of
each 16-channel chunk staged in shared memory, products on WMMA bf16 with
f32 accumulation (an f32 path on the CUDA cores).  Bound on the card:
operations (2 * N*H*W * 9*Cin*Cout on the bf16 tensor cores); the TPU's
stacked shifted copies of the input are not written.

Backward (:class:`Conv3x3`), as the TPU kernel's VJP: the input gradient
is the same convolution of the output gradient with the weights flipped in
(ky, kx) and transposed in (in, out), so dgrad launches the kernel too;
the weight gradient is the nine shifted-input contractions, which the JAX
package leaves to XLA (``einsum``) and the port to ``torch.matmul`` in f32.

The plain version :func:`conv3x3_s1_plain` is the im2col formulation of
the TPU kernel: nine shifted f32 matrix products, summed, cast to x's
type.  CPU tensors take it; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from fbbev_tpu_torch.ops import _cuda

launches = 0        # forward launches
dgrad_launches = 0  # input-gradient launches in the backward


def supports(shape: Sequence[int], cout: int) -> bool:
    """The JAX routing gate (``pallas_conv.py:113-123``: a 3x3 stride-1
    SAME undilated conv with ``Cin % 64 == 0``, ``H >= 4``, ``W >= 8``) on
    an NCHW input shape, plus ``Cout % 16 == 0``: the dgrad launch takes
    Cout as its input channels and the kernel loads 16-channel groups."""
    _, cin, h, w = shape
    return cin % 64 == 0 and h >= 4 and w >= 8 and cout % 16 == 0


def conv3x3_s1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: nine shifted f32 products.  x (N, Cin, H, W), w
    (Cout, Cin, 3, 3) -> (N, Cout, H, W) in x's type, channels-last
    memory."""
    _, _, H, W = x.shape
    xp = F.pad(x.permute(0, 2, 3, 1).float(), (0, 0, 1, 1, 1, 1))
    wk = w.float().permute(2, 3, 1, 0)                  # (3, 3, Cin, Cout)
    out = None
    for dy in range(3):
        for dx in range(3):
            t = torch.matmul(xp[:, dy:dy + H, dx:dx + W], wk[dy, dx])
            out = t if out is None else out + t
    return out.to(x.dtype).permute(0, 3, 1, 2)


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    N, Cin, H, W = x.shape
    Cout = w.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x dtype {x.dtype}")
    if tuple(w.shape) != (Cout, Cin, 3, 3):
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if Cin % 16 or Cout % 16:
        raise ValueError(f"the kernel needs Cin and Cout multiples of 16: "
                         f"Cin={Cin} Cout={Cout}")
    if not w.is_cuda or w.device != x.device:
        raise ValueError("x and w must be on the same card")
    xh = x.permute(0, 2, 3, 1).contiguous()
    wk = w.to(x.dtype).permute(2, 3, 1, 0).contiguous()
    y = torch.empty(N, H, W, Cout, dtype=x.dtype, device=x.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.lib("conv3x3").fbbev_conv3x3
    fn.argtypes = [vp, vp, vp] + [ci] * 6 + [vp]
    fn.restype = ci
    _cuda.check(fn(xh.data_ptr(), wk.data_ptr(), y.data_ptr(),
                   int(x.dtype == torch.bfloat16), N, H, W, Cin, Cout,
                   _cuda.stream_ptr(x)), "conv3x3")
    return y.permute(0, 3, 1, 2)


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward convolution (no gradient recorded): CUDA tensors launch
    the kernel, CPU tensors take the plain version.  Shapes as
    :func:`conv3x3_s1_plain`."""
    _cuda.refuse_grad("conv3x3_s1 (K7; conv3x3 is its differentiable "
                      "form)", x, w)
    if not x.is_cuda:
        return conv3x3_s1_plain(x, w)
    global launches
    y = _launch(x, w)
    launches += 1
    return y


def _dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient: the same convolution with w flipped in (ky, kx) and
    transposed in (in, out)."""
    wt = w.flip(2, 3).transpose(0, 1).to(g.dtype)
    if not g.is_cuda:
        return conv3x3_s1_plain(g, wt)
    global dgrad_launches
    dx = _launch(g, wt)
    dgrad_launches += 1
    return dx


def _wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient: the nine (Cin, Cout) shifted-input contractions in
    f32 (``pallas_conv.py:146-152``), as (Cout, Cin, 3, 3)."""
    N, Cin, H, W = x.shape
    Cout = g.shape[1]
    xp = F.pad(x.permute(0, 2, 3, 1).float(), (0, 0, 1, 1, 1, 1))
    gm = g.permute(0, 2, 3, 1).float().reshape(-1, Cout)
    taps = [torch.matmul(xp[:, dy:dy + H, dx:dx + W].reshape(-1, Cin).t(),
                         gm) for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, Cin, Cout).permute(3, 2, 0, 1)


class Conv3x3(torch.autograd.Function):
    """Differentiable K7: the forward and the input gradient launch the
    kernel; the weight gradient is :func:`_wgrad`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_s1(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _dgrad(g.to(x.dtype), w) if ctx.needs_input_grad[0] else None
        dw = (_wgrad(x, g).to(w.dtype) if ctx.needs_input_grad[1]
              else None)
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 padding-1 convolution on K7 with its custom backward:
    x (N, Cin, H, W), w (Cout, Cin, 3, 3) -> (N, Cout, H, W)."""
    return Conv3x3.apply(x, w)
