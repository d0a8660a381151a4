"""The int8 convolution of the int8 serving path: quantize, s8 x s8 -> s32
convolution, dequantize.

Replaces no TPU kernel: the JAX package runs these convolutions as XLA
convolutions with int32 accumulation (``fbbev_tpu/utils/quantize.py``:
``_quant_nn_conv`` :382, ``_quant_zslab`` :403, ``_quant_zfold`` :429,
``_quant_pointwise`` :460), with no ``pl.pallas_call``.  Stock PyTorch
has no int8 convolution on CUDA (``F.conv2d`` refuses int8,
``torch._int_mm`` is a matmul with shape rules the ASPP's pooled conv and
the stem break), so the port has a kernel of its own.  The four JAX forms
take the same int32 sums: a 2D convolution of any kernel, stride,
dilation, padding and groups, and in 3D a 3x3x3 convolution with padding
1 and stride s or a strided 1x1x1 one.  Function, per module and call
(``quantize.build_qparams`` gives the parameters)::

    xq  = clip(round(x.float() * m_x[c]), -127, 127)   (per-channel)
        = clip(round(x.float() / s_x), -127, 127)      (per-tensor)
    acc = conv(xq, w_q)                                 int32
    y   = (acc.float() * scale[o] + b[o]).to(x.dtype)  scale = s_x * s_w

rounding half to even, each float operation rounded once, in this order.

CUDA kernel (``csrc/conv_s8.cu``): one implicit GEMM, M = the output
pixels N*Do*Ho*Wo, N = the output channels of a group, K = taps x input
channels of the group (tap-major), for 2D (D = 1) and 3D alike.  A block
of 256 threads computes a 128 x BN tile (BN 128, or 64 where a group has
at most 64 output channels) one K step of 32 at a time: its threads read
the activation in its own type through its strides, quantize it in
registers and store int8 to shared memory (out-of-map taps are 0, exact
since q(0) = 0: no int8 copy of the activation exists in device memory),
the packed weights arrive by 16-byte loads, and the products run on the
tensor cores as ``mma.sync.m16n8k32.s8.s8.s32``.  The epilogue converts,
scales, adds the bias and casts in the plain version's order (the build's
``--fmad=false`` keeps the multiply and the add apart), so the kernel
equals its plain version bit for bit, its int32 sums and its outputs.
The weights are packed once (:func:`pack_weight`, K-major, padded to the
MMA's K and to the tile's N) when the parameters are built for a card.
Bound on the card: operations, 2*M*N*K on the int8 tensor cores, for the
large convs; bytes (the activation read once, the output written once) for
the small ones.  The design is the simple one: no pipelining, every K step
behind a barrier, the activation gathered once per N tile.

Layout: x is PyTorch's logical (N, C, H, W) or (N, C, D, H, W) in any
memory layout; the kernel reads it through its strides (the thread map
follows the channel stride: pixels across a warp for NCHW memory,
channels for channels-last), and writes y in x's memory format
(channels-last in, channels-last out).

The plain version :func:`conv_s8_plain` quantizes as above and sums in
float64 with ``F.conv2d`` / ``F.conv3d`` on the integer values (exact
below 2^53; the CPU build has no int8 convolution).  CPU tensors take it;
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fbbev_tpu_torch.ops import _cuda

launches = 0

BK = 32  # the kernel's K step
N_PAD = 128  # the packed weights' output channels, a multiple of any BN
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2))


def quantize_plain(x: torch.Tensor, m_x: Optional[torch.Tensor],
                   s_x: torch.Tensor) -> torch.Tensor:
    """x quantized to int8 values: ``round(x.float() * m_x[c])`` per
    channel (``m_x`` (C,) f32), else ``round(x.float() / s_x)`` (a
    division, as JAX's legacy path); half to even, clipped to +-127."""
    xf = x.float()
    q = (xf * _channel_view(m_x, x.dim()) if m_x is not None
         else xf / s_x)
    return torch.round(q).clamp_(-127.0, 127.0).to(torch.int8)


def sums_plain(xq: torch.Tensor, w_q: torch.Tensor, stride, padding,
               dilation, groups: int) -> torch.Tensor:
    """The int32 sums of int8 ``xq`` (N, C, [D,] H, W) with int8 ``w_q``
    (Cout, C/groups, k...): a float64 convolution of the integer values,
    exact below 2^53; rounded before the cast, which leaves exact sums as
    they are (and would absorb any rounding of a transform-based library
    algorithm)."""
    conv = F.conv2d if xq.dim() == 4 else F.conv3d
    s = conv(xq.double(), w_q.double(), None, stride, padding, dilation,
             groups)
    return s.round().to(torch.int32)


def dequantize_plain(acc: torch.Tensor, qp: dict, dtype) -> torch.Tensor:
    """``(acc.float() * scale + b).to(dtype)``, per output channel."""
    y = acc.float() * _channel_view(qp["scale"], acc.dim())
    if qp["b"] is not None:
        y = y + _channel_view(qp["b"], acc.dim())
    return y.to(dtype)


def conv_s8_plain(x: torch.Tensor, qp: dict, stride, padding, dilation,
                  groups: int, return_sums: bool = False):
    """Plain version; arguments and result as :func:`conv_s8`."""
    acc = sums_plain(quantize_plain(x, qp["m_x"], qp["s_x"]), qp["w_q"],
                     stride, padding, dilation, groups)
    y = dequantize_plain(acc, qp, x.dtype)
    return (y, acc) if return_sums else y


def pack_weight(w_q: torch.Tensor, groups: int) -> torch.Tensor:
    """int8 ``w_q`` (Cout, C/groups, k...) -> (groups, Npad, Kpad) int8,
    K-major (k = tap * C/groups + c, taps in (kd, kh, kw) order), zero
    padded to a multiple of 32 in K and of :data:`N_PAD` in N: the layout
    the kernel's 16-byte B loads read."""
    O, Cg = w_q.shape[:2]
    taps = w_q[0, 0].numel()
    Ng, K = O // groups, taps * Cg
    w = w_q.reshape(groups, Ng, Cg, taps).permute(0, 1, 3, 2).reshape(
        groups, Ng, K)
    out = torch.zeros(groups, -(-Ng // N_PAD) * N_PAD, -(-K // BK) * BK,
                      dtype=torch.int8, device=w_q.device)
    out[:, :Ng, :K] = w
    return out


def _triple(v, n: int, fill: int) -> Tuple[int, ...]:
    """A 2D or 3D conv argument as (d, h, w), ``fill`` for a 2D conv's d."""
    v = tuple(v) if isinstance(v, (tuple, list)) else (v,) * n
    return (fill,) * (3 - n) + v


def out_shape(x_shape: Sequence[int], w_shape: Sequence[int], stride,
              padding, dilation) -> Tuple[int, ...]:
    """The convolution's output shape."""
    n = len(x_shape) - 2
    st, pd, dl = (tuple(v) if isinstance(v, (tuple, list)) else (v,) * n
                  for v in (stride, padding, dilation))
    sp = tuple((x_shape[2 + i] + 2 * pd[i] - dl[i] * (w_shape[2 + i] - 1)
                - 1) // st[i] + 1 for i in range(n))
    return (x_shape[0], w_shape[0]) + sp


def _memory_format(x: torch.Tensor):
    cl = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    if not x.is_contiguous() and x.is_contiguous(memory_format=cl):
        return cl
    return torch.contiguous_format


def conv_s8(x: torch.Tensor, qp: dict, stride, padding, dilation,
            groups: int, return_sums: bool = False):
    """The int8 convolution of one module: x (N, C, H, W) or (N, C, D, H,
    W), f32, bf16 or f16; ``qp`` from ``quantize.build_qparams`` (``w_q``
    int8 (Cout, C/groups, k...), ``scale`` f32 (Cout,), ``b`` f32 or None,
    ``m_x`` f32 (C,) or None and then ``s_x`` f32 (); on a card also
    ``w_k``, the packed weights); ``stride``, ``padding``, ``dilation`` as
    ``nn.Conv2d``'s / ``nn.Conv3d``'s (integer padding).  Returns y in x's
    type and memory format, and with ``return_sums`` also the int32 sums.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    No backward."""
    _cuda.refuse_grad("conv_s8", x)
    if not x.is_cuda:
        return conv_s8_plain(x, qp, stride, padding, dilation, groups,
                             return_sums)
    global launches
    n = x.dim() - 2
    if n not in (2, 3) or x.dtype not in _DTYPES:
        raise ValueError(f"conv_s8: x {tuple(x.shape)} {x.dtype}: needs "
                         f"(N, C, [D,] H, W) f32, bf16 or f16")
    if "w_k" not in qp:
        raise ValueError("conv_s8: the parameters hold no packed weights "
                         "(build them on the card: quantize.build_qparams)")
    w_q, w_k = qp["w_q"], qp["w_k"]
    C, O = x.shape[1], w_q.shape[0]
    if (w_q.dim() != x.dim() or C != w_q.shape[1] * groups or O % groups
            or w_k.shape[0] != groups):
        raise ValueError(f"conv_s8: x {tuple(x.shape)} and w_q "
                         f"{tuple(w_q.shape)} at groups {groups}")
    if any(not isinstance(p, int) for p in _triple(padding, n, 0)):
        raise ValueError(f"conv_s8: padding {padding}")
    per_channel = qp["m_x"] is not None
    if per_channel and groups != 1:
        raise ValueError("conv_s8: per-channel smoothing of a grouped conv")
    shape = out_shape(x.shape, w_q.shape, stride, padding, dilation)
    if min(shape) <= 0 or max(x.numel(), O * w_q[0].numel()) >= 2 ** 31:
        raise ValueError(f"conv_s8: x {tuple(x.shape)} -> {shape}")
    y = torch.empty(shape, dtype=x.dtype, device=x.device,
                    memory_format=_memory_format(x))
    acc = torch.empty_like(y, dtype=torch.int32) if return_sums else None
    for t in (w_k, qp["scale"], qp["b"], qp["m_x"], qp["s_x"]):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError("conv_s8: parameters not contiguous on x's "
                             "device")
    if x.dim() == 4:
        x5, y5 = x.unsqueeze(2), y.unsqueeze(2)
        ks = (1,) + tuple(w_q.shape[2:])
    else:
        x5, y5, ks = x, y, tuple(w_q.shape[2:])
    st, pd, dl = (_triple(v, n, f) for v, f in ((stride, 1), (padding, 0),
                                                 (dilation, 1)))
    Ng, Cg = O // groups, C // groups
    K = Cg * ks[0] * ks[1] * ks[2]
    M = shape[0] * y5.shape[2] * y5.shape[3] * y5.shape[4]
    f = _cuda.entry("conv_s8", "fbbev_conv_s8", 8, 41)
    _cuda.check(f(
        x.data_ptr(), w_k.data_ptr(), qp["scale"].data_ptr(),
        0 if qp["b"] is None else qp["b"].data_ptr(),
        qp["m_x"].data_ptr() if per_channel else 0,
        0 if per_channel else qp["s_x"].data_ptr(),
        y.data_ptr(), 0 if acc is None else acc.data_ptr(),
        _DTYPES[x.dtype], *x5.shape, *x5.stride(), O, *y5.shape[2:],
        *y5.stride(), *ks, *st, *pd, *dl, groups, Cg, Ng, K, w_k.shape[2],
        w_k.shape[1], M, int(x.stride(1) == 1 and C > 1),
        128 if Ng > 64 else 64, _cuda.stream_ptr(x)), "conv_s8")
    launches += 1
    return (y, acc) if return_sums else y
