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

CUDA kernel (``csrc/conv_s8.cu``), three launches a call:

1. A quantize pass reads x once through its strides (NCHW or
   channels-last, 2D or 3D, f32 / bf16 / f16) and writes it int8 and
   channels-last to a workspace (N, D, H, W, Cp), Cp = C rounded up to 16
   (:func:`quantize_cl`; plain version :func:`quantize_cl_plain`).  A
   stride-2 conv of at most 4 channels (the stem, C = 3) runs as its
   space-to-depth form instead, a stride-1 conv of a quarter the taps over
   4C channels (:func:`s2d_geometry`, :func:`quantize_s2d_plain`,
   :func:`s2d_weight`).
2. An implicit GEMM on TMA and ``wgmma``: M = output pixels, N = output
   channels of a group, K = the live taps x the group's channels.  An M
   tile is a (TD, TY, TX) box of output pixels of one image -- a 2D conv
   is a 3D one with D = 1 -- or, for a 1x1 stride-1 unpadded conv, BM
   consecutive pixels of the flattened map ("flat").  A K step is one tap
   x BK channels: ONE TMA box of the workspace at the tap's shifted
   origin (strides by the tensor map's element strides, the padding and
   the ragged edge by TMA's zero fill, exact since q(0) = 0) and one of
   the packed weights (:func:`pack_weight`), into a ring of stages that
   one producer thread keeps full; consumer warpgroups multiply on
   ``wgmma.m64nBNk32.s32.s8.s8``; the GEMM is the quantize pass's
   programmatic dependent.  BK = 128, 64 or 32 channels land in the 128-,
   64- or 32-byte swizzle; a group of at most 16 channels takes two
   unswizzled 16-channel taps a step.  A tap whose
   shifted box has no input pixel on the map is neither loaded nor
   multiplied (:func:`live_taps`; exact, it multiplies only zeros).  A
   grouped conv's box starts at its group's channel offset.  Where M is
   too small to fill the card, the live K steps split S ways into int32
   partials (integer sums: exact in any order);
3. with S > 1, a pass that sums them and applies the epilogue.

The epilogue stages the int32 sums in shared memory and converts,
scales, adds the bias and casts in the plain version's order (the
build's ``--fmad=false`` keeps the multiply and the add apart), so the
kernel equals its plain version bit for bit, its int32 sums and its
outputs.  The tile plan -- box, BM, BN, BK, S, stages -- is
:func:`plan_s8`'s, computed here and passed to the kernel as ints.  Bound
on the card: operations (2 x the in-map products on the int8 tensor
cores) for the large convs; bytes (the activation read once, the output
written once) for the small ones.

Layout: x is PyTorch's logical (N, C, H, W) or (N, C, D, H, W) in any
memory layout; y comes back in x's memory format (channels-last in,
channels-last out).

The plain version :func:`conv_s8_plain` quantizes as above and sums in
float64 with ``F.conv2d`` / ``F.conv3d`` on the integer values (exact
below 2^53; the CPU build has no int8 convolution).  CPU tensors take it;
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fbbev_tpu_torch.ops import _cuda

launches = 0           # conv calls on the card
quantize_launches = 0  # the quantize pass alone (:func:`quantize_cl`)

C_ALIGN = 16   # Cp, Cpad: TMA's 16-byte stride rule
N_ALIGN = 16   # Npad
MAX_TAPS = 64  # KD * KH * KW the kernel's tap list holds
MAX_STAGES = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


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


def quantize_cl_plain(x: torch.Tensor, m_x: Optional[torch.Tensor],
                      s_x: torch.Tensor) -> torch.Tensor:
    """The quantize pass's result: :func:`quantize_plain` of x (N, C, [D,]
    H, W) as an int8 channels-last (N, D, H, W, Cp) tensor (D = 1 for a 2D
    x), Cp = C rounded up to 16, zeros in the channel padding."""
    q = quantize_plain(x, m_x, s_x)
    if q.dim() == 4:
        q = q.unsqueeze(2)
    N, C, D, H, W = q.shape
    out = torch.zeros(N, D, H, W, _round_up(C, C_ALIGN), dtype=torch.int8,
                      device=x.device)
    out[..., :C] = q.permute(0, 2, 3, 4, 1)
    return out


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
    """int8 ``w_q`` (Cout, C/groups, k...) -> (groups, taps, Npad, Cpad)
    int8, K-major (a tap's (Npad, Cpad) slab: output channel n of the
    group, input channel c), taps in (kd, kh, kw) order, zero past the
    group's Cout / groups and C / groups, padded to multiples of 16: the
    tensor the kernel's weight boxes read."""
    O, Cg = w_q.shape[:2]
    taps = w_q[0, 0].numel()
    Ng = O // groups
    w = w_q.reshape(groups, Ng, Cg, taps).permute(0, 3, 1, 2)
    out = torch.zeros(groups, taps, _round_up(Ng, N_ALIGN),
                      _round_up(Cg, C_ALIGN), dtype=torch.int8,
                      device=w_q.device)
    out[:, :, :Ng, :Cg] = w
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


class Conv(NamedTuple):
    """A conv's geometry in 3D form (a 2D conv has D = Do = KD = 1):
    input (N, C, D, H, W), output (N, Co, Do, Ho, Wo), kernel (KD, KH, KW),
    strides, paddings, dilations, G groups of Cg input and Ng output
    channels."""
    N: int
    C: int
    D: int
    H: int
    W: int
    Co: int
    Do: int
    Ho: int
    Wo: int
    KD: int
    KH: int
    KW: int
    sd: int
    sh: int
    sw: int
    pd: int
    ph: int
    pw: int
    dd: int
    dh: int
    dw: int
    G: int
    Cg: int
    Ng: int


def conv_geometry(x_shape: Sequence[int], w_shape: Sequence[int], stride,
                  padding, dilation, groups: int) -> Conv:
    """The :class:`Conv` of x (N, C, [D,] H, W) and w (Cout, C/groups,
    k...) under these conv arguments."""
    n = len(x_shape) - 2
    y = out_shape(x_shape, w_shape, stride, padding, dilation)
    sp = (1,) * (3 - n)
    st, pd, dl = (_triple(v, n, f) for v, f in ((stride, 1), (padding, 0),
                                                 (dilation, 1)))
    return Conv(x_shape[0], x_shape[1], *(sp + tuple(x_shape[2:])),
                w_shape[0], *(sp + tuple(y[2:])),
                *(sp + tuple(w_shape[2:])), *st, *pd, *dl, groups,
                x_shape[1] // groups, w_shape[0] // groups)


class Plan(NamedTuple):
    """The kernel's tiling of one conv: ``flat`` (rows = BM consecutive
    pixels of the flattened map) or a box of (TD, TY, TX) output pixels of
    one image in a tile of BM >= TD * TY * TX rows; BN output channels a
    block; BK channels a K step (16: two taps a step); the live K steps
    split S ways; ``stages`` ring stages.  Grid: (M tiles, tiles_n, G *
    S), M tiles = N * tiles_d * tiles_y * tiles_x (flat: tiles_x)."""
    flat: bool
    TD: int
    TY: int
    TX: int
    BM: int
    BN: int
    BK: int
    S: int
    stages: int
    tiles_d: int
    tiles_y: int
    tiles_x: int
    tiles_n: int


def s2d_geometry(cv: Conv) -> Optional[Conv]:
    """A 2D stride-2 undilated conv of at most 4 input channels (the stem,
    C = 3) as the stride-1 conv the kernel runs instead, or None: space to
    depth, ``xs[n, i, j, (py * 2 + px) * C + c] = x[n, c, 2i + py - ph, 2j
    + px - pw]`` (:func:`quantize_s2d_plain`) with ceil(k / 2) taps a side
    (:func:`s2d_weight`), no padding.  Its input rows are 16 bytes of
    adjacent pixels where the strided taps' were 16 bytes every other
    pixel, and its K steps a quarter of theirs."""
    if (cv.D != 1 or cv.G != 1 or cv.C > 4 or (cv.sh, cv.sw) != (2, 2)
            or (cv.dh, cv.dw) != (1, 1)):
        return None
    kh, kw = -(-cv.KH // 2), -(-cv.KW // 2)
    return cv._replace(C=4 * cv.C, H=cv.Ho + kh - 1, W=cv.Wo + kw - 1,
                       KH=kh, KW=kw, sh=1, sw=1, ph=0, pw=0, Cg=4 * cv.C)


def quantize_s2d_plain(x: torch.Tensor, m_x: Optional[torch.Tensor],
                       s_x: torch.Tensor, cv: Conv) -> torch.Tensor:
    """The space-to-depth quantize pass of conv ``cv`` (see
    :func:`s2d_geometry`): (N, 1, H2, W2, 16) int8, channel (py * 2 + px)
    * C + c, zeros off x and past 4C."""
    g = s2d_geometry(cv)
    q = quantize_plain(x, m_x, s_x)
    N, C, H, W = q.shape
    q = F.pad(q, (cv.pw, 2 * g.W - W - cv.pw, cv.ph, 2 * g.H - H - cv.ph))
    q = q.reshape(N, C, g.H, 2, g.W, 2).permute(0, 2, 4, 3, 5, 1)
    out = torch.zeros(N, 1, g.H, g.W, C_ALIGN, dtype=torch.int8,
                      device=x.device)
    out[:, 0, ..., :4 * C] = q.reshape(N, g.H, g.W, 4 * C)
    return out


def s2d_weight(w_q: torch.Tensor) -> torch.Tensor:
    """(Cout, C, k, k') int8 weights of a stride-2 conv as those of its
    space-to-depth form (Cout, 4C, ceil(k / 2), ceil(k' / 2)):
    ``w[o, (py * 2 + px) * C + c, ty, tx] = w_q[o, c, 2ty + py, 2tx + px]``,
    zero past k, k'."""
    O, C, kh, kw = w_q.shape
    w = F.pad(w_q, (0, kw % 2, 0, kh % 2))
    w = w.reshape(O, C, -(-kh // 2), 2, -(-kw // 2), 2)
    return w.permute(0, 3, 5, 1, 2, 4).reshape(O, 4 * C, -(-kh // 2),
                                               -(-kw // 2)).contiguous()


def is_flat(cv: Conv) -> bool:
    """A 1x1(x1) stride-1 unpadded conv: its rows are the map's pixels."""
    return (cv.KD, cv.KH, cv.KW, cv.sd, cv.sh, cv.sw, cv.pd, cv.ph,
            cv.pw) == (1, 1, 1, 1, 1, 1, 0, 0, 0)


def axis_live(o0: int, cnt: int, s: int, p: int, k: int, dl: int,
              I: int) -> bool:
    """Is the tap at offset k of one axis live for ``cnt`` outputs from
    ``o0``: does some input coordinate ``o * s - p + k * dl`` lie in [0,
    I)?  (The kernel's ``axis_live``.)"""
    lo = o0 * s - p + k * dl
    j0 = 0 if lo >= 0 else -(lo // s)
    return j0 < cnt and lo + j0 * s < I


def tile_origin(cv: Conv, plan: Plan, mt: int):
    """M tile ``mt``'s image and first output pixel (n, od0, oh0, ow0);
    flat: (0, 0, 0, first flat pixel)."""
    if plan.flat:
        return 0, 0, 0, mt * plan.BM
    per = plan.tiles_d * plan.tiles_y * plan.tiles_x
    r = mt % per
    return (mt // per, r // (plan.tiles_y * plan.tiles_x) * plan.TD,
            r // plan.tiles_x % plan.tiles_y * plan.TY,
            r % plan.tiles_x * plan.TX)


def live_taps(cv: Conv, plan: Plan, mt: int):
    """The taps (kd * KH + kh) * KW + kw, in order, that M tile ``mt``
    loads and multiplies: those whose shifted box has an input pixel on
    the map for one of the tile's output pixels."""
    if plan.flat:
        return [0]
    _, od0, oh0, ow0 = tile_origin(cv, plan, mt)
    cd = min(od0 + plan.TD, cv.Do) - od0
    ch = min(oh0 + plan.TY, cv.Ho) - oh0
    cw = min(ow0 + plan.TX, cv.Wo) - ow0
    return [(kd * cv.KH + kh) * cv.KW + kw
            for kd in range(cv.KD)
            if axis_live(od0, cd, cv.sd, cv.pd, kd, cv.dd, cv.D)
            for kh in range(cv.KH)
            if axis_live(oh0, ch, cv.sh, cv.ph, kh, cv.dh, cv.H)
            for kw in range(cv.KW)
            if axis_live(ow0, cw, cv.sw, cv.pw, kw, cv.dw, cv.W)]


def k_steps(cv: Conv, BK: int, n_taps: int) -> int:
    """A tile's K steps: two taps a step at BK = 16, else taps x
    ceil(Cg / BK) channel boxes."""
    if BK == 16:
        return (n_taps + 1) // 2
    return n_taps * -(-cv.Cg // BK)


def split_range(steps: int, S: int, split: int) -> Tuple[int, int]:
    """The K steps [s0, s1) of split ``split`` of S (the kernel's)."""
    return split * steps // S, (split + 1) * steps // S


# The time model of :func:`plan_s8` (H100 SXM: 132 SMs, 3.35 TB/s of
# HBM): a block's K step takes STEP_S[BM, BN, BK] with the blocks resident
# together on an SM (by default the longer of its products at the SM's
# share of the int8 peak and its two boxes at L2_BPS_SM, plus
# STEP_FIXED_S); a wave of blocks adds WAVE_S; a split adds its int32
# partials through HBM and SPLIT_S; every output element OUT_S; every byte
# the grid's boxes bring L2_S; a call FIXED_S.
SMS = 132
MAC_PER_SM = 1979e12 / 2 / SMS
L2_BPS_SM = 40e9
HBM_BPS = 3.35e12
# STEP_S, WAVE_S, SPLIT_S, OUT_S, FIXED_S, L2_S: a least-squares fit to
# the graph times of 2810 plans at the int8 convs of a flagship frame with
# the BEV side and of a VoVNet-99 frame (``chip_smoke.py --s8-plans`` on
# an H100 80GB HBM3 at 700 W: relative error median 0.124).
STEP_S = {(64, 64, 16): 2.2269e-07, (64, 64, 32): 1.6514e-07,
          (64, 64, 64): 2.0830e-07, (64, 64, 128): 5.2142e-07,
          (64, 128, 32): 2.4741e-07, (64, 128, 64): 3.2277e-07,
          (64, 128, 128): 5.9588e-07, (64, 256, 32): 3.8640e-07,
          (64, 256, 64): 6.1078e-07, (64, 256, 128): 7.3998e-07,
          (128, 64, 16): 1.7000e-07, (128, 64, 32): 2.5650e-07,
          (128, 64, 64): 3.7143e-07, (128, 64, 128): 6.8197e-07,
          (128, 128, 32): 6.8167e-07, (128, 128, 64): 6.8706e-07,
          (128, 128, 128): 8.2643e-07, (128, 256, 32): 7.1535e-07,
          (128, 256, 64): 8.2924e-07, (128, 256, 128): 1.2582e-06}
STEP_FIXED_S = 1.0e-7
WAVE_S = 4.0635e-06
SPLIT_S = 1.6444e-06
OUT_S = 1.5600e-12
FIXED_S = 3.4751e-06
L2_S = 4.7463e-14
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
MAX_DYN = 227 * 1024 - 4096  # a block's dynamic shared memory at most
EPI_BYTES = 64 * 68 * 4  # the epilogue's staging of a warpgroup's sums
SMEM_SM = 233472         # shared memory an SM's blocks share
SMEM_BLOCK = 4096 + 1024  # a block's static arrays and the runtime's share
# registers a thread of conv_s8_wgmma<*, BN> takes (ptxas -v on sm_90a,
# rounded up to 8)
REGS = {64: 80, 128: 112, 256: 168}


def _extents(O: int, limit: int):
    """Box extents along an axis of O outputs: the equal cuts ceil(O / k)
    and the powers of two below O, at most ``limit``."""
    out = {-(-O // k) for k in range(1, O + 1)}
    out |= {1 << j for j in range(max(0, (O - 1).bit_length()))}
    return sorted(e for e in out if 1 <= e <= limit)


@functools.lru_cache(maxsize=4096)
def _axis_sum(O: int, T: int, s: int, p: int, K: int, dl: int,
              I: int) -> int:
    """Over the boxes of extent T along an axis of O outputs, the sum of
    their live taps on that axis."""
    return sum(axis_live(o0, min(o0 + T, O) - o0, s, p, k, dl, I)
               for o0 in range(0, O, T) for k in range(K))


def live_total(cv: Conv, TD: int, TY: int, TX: int) -> int:
    """Over the (TD, TY, TX) boxes of every image, the sum of their live
    taps (:func:`live_taps`): liveness factors over the three axes."""
    return cv.N * (_axis_sum(cv.Do, TD, cv.sd, cv.pd, cv.KD, cv.dd, cv.D)
                   * _axis_sum(cv.Ho, TY, cv.sh, cv.ph, cv.KH, cv.dh, cv.H)
                   * _axis_sum(cv.Wo, TX, cv.sw, cv.pw, cv.KW, cv.dw, cv.W))


def ring(BM: int, BN: int, BK: int, steps: int = MAX_STAGES
         ) -> Tuple[int, int, int]:
    """(stage bytes, stages, blocks an SM) of a BM x BN tile at BK whose
    blocks walk at most ``steps`` K steps: no deeper than the steps (at
    least 2, and deep enough to stage the epilogue), as many blocks an SM
    as shared memory, registers and threads allow."""
    stage = (BM + BN) * (32 if BK == 16 else BK)
    need = -(-(BM // 64) * EPI_BYTES // stage)
    stages = max(2, need, min(MAX_STAGES, (MAX_DYN - 1024 - 128) // stage,
                             steps))
    return stage, stages, blocks_per_sm(BM, BN, smem_bytes(BM, stage,
                                                           stages))


def smem_bytes(BM: int, stage: int, stages: int) -> int:
    """A block's dynamic shared memory: 1024 of alignment slack, the ring
    (which stages the epilogue), the barriers (the kernel's layout)."""
    return 1024 + stages * stage + 128


def blocks_per_sm(BM: int, BN: int, dyn: int) -> int:
    """The blocks of a BM x BN tile with ``dyn`` bytes of dynamic shared
    memory that an SM holds at once: by shared memory, registers and
    threads."""
    threads = BM * 2 + 32
    return max(1, min(SMEM_SM // (dyn + SMEM_BLOCK),
                      65536 // (-(-threads // 32) * 32 * REGS[BN]),
                      2048 // threads))


def _tile_steps(cv: Conv, p: Plan) -> Tuple[int, float]:
    """(M tiles, their mean K steps) of plan ``p``."""
    if p.flat:
        tiles_m = live = p.tiles_x
    else:
        tiles_m = cv.N * p.tiles_d * p.tiles_y * p.tiles_x
        live = live_total(cv, p.TD, p.TY, p.TX)
    return tiles_m, ((live + tiles_m) / 2 if p.BK == 16
                     else live * -(-cv.Cg // p.BK)) / tiles_m


def step_time(BM: int, BN: int, BK: int) -> float:
    """Seconds of a K step of a BM x BN block at BK (:data:`STEP_S`, else
    the default of the module's time model)."""
    if (BM, BN, BK) in STEP_S:
        return STEP_S[BM, BN, BK]
    k = 32 if BK == 16 else BK
    return max(BM * BN * k / MAC_PER_SM,
               (BM + BN) * k / L2_BPS_SM) + STEP_FIXED_S


def model_terms(cv: Conv, p: Plan, sms: int = SMS) -> dict:
    """The terms of plan ``p``'s modelled time, each to be multiplied by
    its constant: ``steps`` (waves x a block's K steps x the blocks an SM
    runs together; by STEP_S[BM, BN, BK]), ``waves`` (WAVE_S), ``split``
    (1 where S > 1; SPLIT_S), ``partial_bytes`` (the int32 partials
    written and read back; / HBM_BPS), ``out`` (output elements; OUT_S),
    ``call`` (1; FIXED_S), ``l2`` (the bytes every block's boxes bring
    to shared memory; L2_S)."""
    tiles_m, steps = _tile_steps(cv, p)
    blocks = tiles_m * p.tiles_n * cv.G * p.S
    slots = blocks_per_sm(p.BM, p.BN, smem_bytes(
        p.BM, ring(p.BM, p.BN, p.BK)[0], p.stages))
    waves = -(-blocks // (sms * slots))
    conc = min(slots, -(-blocks // sms))
    out = cv.N * cv.Do * cv.Ho * cv.Wo * cv.Co
    rows = p.BM if p.flat else p.TD * p.TY * p.TX
    k = 32 if p.BK == 16 else p.BK
    return dict(steps=waves * steps / p.S * conc, waves=waves,
                split=int(p.S > 1),
                partial_bytes=8 * p.S * out if p.S > 1 else 0, out=out,
                call=1, l2=blocks * steps / p.S * (rows + p.BN) * k)


def modelled_time(cv: Conv, p: Plan, sms: int = SMS) -> float:
    """Seconds plan ``p`` is modelled to take (:func:`model_terms` times
    the module's constants)."""
    t = model_terms(cv, p, sms)
    return (t["steps"] * step_time(p.BM, p.BN, p.BK) + t["waves"] * WAVE_S
            + t["split"] * SPLIT_S + t["partial_bytes"] / HBM_BPS
            + t["out"] * OUT_S + FIXED_S + t["l2"] * L2_S)


def plans_s8(cv: Conv, sms: int = SMS):
    """Every plan :func:`plan_s8` considers, with its ranking key."""
    flat = is_flat(cv)
    P = cv.N * cv.D * cv.H * cv.W
    bks = ((16,) if cv.Cg <= 16 else
           tuple(b for b in (32, 64, 128) if b <= max(32, _round_up(cv.Cg,
                                                                    32))))
    bns = tuple(b for b in (64, 128, 256) if b <= max(64, _round_up(cv.Ng,
                                                                    64)))
    out = []
    for BM in (128, 64):
        # boxes (TD, TY, TX): the four of the fewest live taps
        if flat:
            boxes = [(1, 1, BM)]
        else:
            cands = []
            for TX in _extents(cv.Wo, min(BM, 256 // cv.sw)):
                for TY in _extents(cv.Ho, min(BM // TX, 256 // cv.sh)):
                    TD = _extents(cv.Do, min(BM // (TX * TY),
                                             256 // cv.sd))[-1]
                    tiles = (cv.N * -(-cv.Do // TD) * -(-cv.Ho // TY)
                             * -(-cv.Wo // TX))
                    cands.append((live_total(cv, TD, TY, TX), tiles,
                                  tiles * TD * TY * TX, (TD, TY, TX)))
            boxes = [c[3] for c in sorted(cands)[:4]]
        for TD, TY, TX in boxes:
            if flat:
                nd, ny, nx = 1, 1, -(-P // BM)
                area = nx * BM
            else:
                nd, ny, nx = (-(-cv.Do // TD), -(-cv.Ho // TY),
                              -(-cv.Wo // TX))
                area = cv.N * nd * ny * nx * TD * TY * TX
            for BN in bns:
                tiles_n = -(-cv.Ng // BN)
                for BK in bks:
                    p = Plan(flat, TD, TY, TX, BM, BN, BK, 1, 0, nd, ny, nx,
                             tiles_n)
                    tiles_m, steps = _tile_steps(cv, p)
                    slots = ring(BM, BN, BK, int(steps) + 1)[2]
                    for S in SPLITS:
                        if S > 1 and (tiles_m * tiles_n * cv.G >= sms * slots
                                      or S > steps):
                            continue  # no idle SMs, or empty splits
                        p = p._replace(S=S, stages=ring(
                            BM, BN, BK, -(-int(steps) // S) + 1)[1])
                        key = (round(modelled_time(cv, p, sms) * 1e8), area,
                               -BM, S, -BK)
                        out.append((key, p))
    return out


@functools.lru_cache(maxsize=1024)
def plan_s8(cv: Conv, sms: int = SMS) -> Plan:
    """The kernel's plan for conv ``cv`` on a card of ``sms`` SMs: flat
    where :func:`is_flat`, else over BM in (128, 64) the four boxes of the
    fewest live K steps (box extents per axis from :func:`_extents`, at
    most 256 input elements a box edge); BN in (64, 128, 256) up to Ng
    rounded to 64; BK 16 for groups of <= 16 channels, else 32, 64 or 128
    up to Cg rounded to 32; splits S in :data:`SPLITS` where the unsplit
    grid leaves SMs idle: the least modelled time (module constants), ties
    to the smaller padded area, the larger BM, the smaller S, the larger
    BK."""
    if cv.KD * cv.KH * cv.KW > MAX_TAPS:
        raise ValueError(f"conv_s8: {cv.KD * cv.KH * cv.KW} taps > "
                         f"{MAX_TAPS}")
    return min(plans_s8(cv, sms))[1]


def _memory_format(x: torch.Tensor):
    cl = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    if not x.is_contiguous() and x.is_contiguous(memory_format=cl):
        return cl
    return torch.contiguous_format


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.dim() not in (4, 5) or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}: needs "
                         f"(N, C, [D,] H, W) f32, bf16 or f16")


def _x5(x: torch.Tensor) -> torch.Tensor:
    return x.unsqueeze(2) if x.dim() == 4 else x


def quantize_cl(x: torch.Tensor, m_x: Optional[torch.Tensor],
                s_x: torch.Tensor, cv: Optional[Conv] = None
                ) -> torch.Tensor:
    """The kernel's quantize pass alone (on a card; CPU tensors take the
    plain versions): x (N, C, [D,] H, W) f32 / bf16 / f16 -> int8 (N, D,
    H, W, Cp); for a conv ``cv`` that :func:`s2d_geometry` takes, its
    space-to-depth pass (:func:`quantize_s2d_plain`'s result)."""
    g = s2d_geometry(cv) if cv is not None else None
    if not x.is_cuda:
        return (quantize_cl_plain(x, m_x, s_x) if g is None
                else quantize_s2d_plain(x, m_x, s_x, cv))
    global quantize_launches
    _check_x("quantize_cl", x)
    if x.numel() >= 2 ** 31:
        raise ValueError(f"quantize_cl: x {tuple(x.shape)}")
    for t in (m_x, s_x):
        if t is not None and (t.device != x.device or not t.is_contiguous()
                              or t.dtype != torch.float32):
            raise ValueError("quantize_cl: m_x / s_x not contiguous f32 on "
                             "x's device")
    x5 = _x5(x)
    N, C, D, H, W = x5.shape
    Cp = _round_up(C if g is None else g.C, C_ALIGN)
    xq = (torch.empty(N, D, H, W, Cp, dtype=torch.int8, device=x.device)
          if g is None else torch.empty(N, 1, g.H, g.W, Cp, dtype=torch.int8,
                                        device=x.device))
    f = _cuda.entry("conv_s8", "fbbev_s8_quantize", 4, 17)
    _cuda.check(f(x.data_ptr(), 0 if m_x is None else m_x.data_ptr(),
                  0 if m_x is not None else s_x.data_ptr(), xq.data_ptr(),
                  _DTYPES[x.dtype], N, C, D, H, W, *x5.stride(), Cp,
                  int(g is not None), 0 if g is None else g.H,
                  0 if g is None else g.W, 0 if g is None else cv.ph,
                  0 if g is None else cv.pw, _cuda.stream_ptr(x)),
                "conv_s8 quantize")
    quantize_launches += 1
    return xq


class Call(NamedTuple):
    """What one call signature of :func:`conv_s8` needs beyond its
    pointers: the GEMM's geometry (the space-to-depth form's, where
    :func:`s2d_geometry` gives one), the plan, y's shape and memory format,
    the workspace's bytes (the int8 activation, then the int32 partials at
    ``part_at``), the entry's ints (a ctypes array) and, for the
    space-to-depth form, its packed weights."""
    cv: Conv
    plan: Plan
    shape: Tuple[int, ...]
    memory_format: torch.memory_format
    ws_bytes: int
    part_at: int
    prm: object
    w_k: Optional[torch.Tensor]  # the space-to-depth form's packed weights


def _arg(v):
    return tuple(v) if isinstance(v, list) else v


def prepare(x: torch.Tensor, qp: dict, stride, padding, dilation,
            groups: int, plan: Optional[Plan] = None) -> Call:
    """Check a call on the card -- shapes, types, the parameters' devices
    and layout; raises on what the kernel does not take -- and make its
    :class:`Call`, under :func:`plan_s8`'s plan or ``plan``."""
    _check_x("conv_s8", x)
    if "w_k" not in qp:
        raise ValueError("conv_s8: the parameters hold no packed weights "
                         "(build them on the card: quantize.build_qparams)")
    w_q, w_k = qp["w_q"], qp["w_k"]
    C, O = x.shape[1], w_q.shape[0]
    if (w_q.dim() != x.dim() or C != w_q.shape[1] * groups or O % groups
            or w_k.dim() != 4 or w_k.shape[0] != groups
            or w_k.shape[1] != w_q[0, 0].numel()):
        raise ValueError(f"conv_s8: x {tuple(x.shape)} and w_q "
                         f"{tuple(w_q.shape)} at groups {groups}")
    n = x.dim() - 2
    if any(not isinstance(p, int) for p in _triple(padding, n, 0)):
        raise ValueError(f"conv_s8: padding {padding}")
    if qp["m_x"] is not None and groups != 1:
        raise ValueError("conv_s8: per-channel smoothing of a grouped conv")
    for t in (w_k, qp["scale"], qp["b"], qp["m_x"], qp["s_x"]):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError("conv_s8: parameters not contiguous on x's "
                             "device")
    shape = out_shape(x.shape, w_q.shape, stride, padding, dilation)
    if min(shape) <= 0 or max(x.numel(), O * w_q[0].numel()) >= 2 ** 31:
        raise ValueError(f"conv_s8: x {tuple(x.shape)} -> {shape}")
    cv = conv_geometry(tuple(x.shape), tuple(w_q.shape), stride, padding,
                       dilation, groups)
    Cp = _round_up(C, C_ALIGN)
    if (max(cv.sd, cv.sh, cv.sw) > 8 or cv.KD * cv.KH * cv.KW > MAX_TAPS
            or x.numel() // C * Cp >= 2 ** 31):
        raise ValueError(f"conv_s8: stride {stride} / kernel "
                         f"{tuple(w_q.shape[2:])} / x {tuple(x.shape)}: "
                         f"not taken by the kernel")
    gv = s2d_geometry(cv) or cv  # the GEMM's conv
    w_s2d = pack_weight(s2d_weight(w_q), 1) if gv is not cv else None
    wk = w_k if w_s2d is None else w_s2d
    p = plan or plan_s8(gv, _cuda.sm_count(x.device))
    fmt = _memory_format(x)
    ys = torch.empty(shape, device="meta", memory_format=fmt)
    Cp = _round_up(gv.C, C_ALIGN)
    ints = (_DTYPES[x.dtype], gv.N, gv.C, gv.D, gv.H, gv.W,
            *_x5(x).stride(), Cp, O, gv.Do, gv.Ho, gv.Wo, *_x5(ys).stride(),
            gv.KD, gv.KH, gv.KW, gv.sd, gv.sh, gv.sw, gv.pd, gv.ph, gv.pw,
            gv.dd, gv.dh, gv.dw, groups, gv.Cg, gv.Ng, wk.shape[2],
            wk.shape[3], int(p.flat), p.TD, p.TY, p.TX, p.BM, p.BN, p.BK,
            p.S, p.stages, int(gv is not cv), cv.C, cv.H, cv.W, cv.ph, cv.pw)
    xq = _round_up(gv.N * gv.D * gv.H * gv.W * Cp, 256)
    part = 4 * p.S * cv.N * cv.Do * cv.Ho * cv.Wo * O if p.S > 1 else 0
    return Call(gv, p, shape, fmt, xq + part, xq,
                (ctypes.c_int * len(ints))(*ints), w_s2d)


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
    No backward.  A call signature -- x's shape, strides, type and card,
    the conv arguments -- is checked and planned once per packed weight
    tensor (:func:`prepare`; the calls live on ``w_k``, as long as it)."""
    _cuda.refuse_grad("conv_s8", x)
    if not x.is_cuda:
        return conv_s8_plain(x, qp, stride, padding, dilation, groups,
                             return_sums)
    global launches
    key = (x.shape, x.stride(), x.dtype, x.get_device(), _arg(stride),
           _arg(padding), _arg(dilation), groups)
    calls = getattr(qp.get("w_k"), "_conv_s8_calls", None)
    c = None if calls is None else calls.get(key)
    if c is None:
        c = prepare(x, qp, stride, padding, dilation, groups)
        if calls is None:
            calls = qp["w_k"]._conv_s8_calls = {}
        calls[key] = c
    y, acc = launch(x, qp, c, return_sums)
    launches += 1
    return (y, acc) if return_sums else y


def launch(x: torch.Tensor, qp: dict, c: Call, return_sums: bool = False):
    """One launch of the kernel for call ``c`` (:func:`prepare` checked x
    and ``qp``): (y, the sums or None).  Counts nothing; a plan sweep
    calls it directly."""
    y = torch.empty(c.shape, dtype=x.dtype, device=x.device,
                    memory_format=c.memory_format)
    acc = torch.empty_like(y, dtype=torch.int32) if return_sums else None
    ws = torch.empty(c.ws_bytes, dtype=torch.uint8, device=x.device)
    w = ws.data_ptr()
    m_x, b = qp["m_x"], qp["b"]
    w_k = qp["w_k"] if c.w_k is None else c.w_k
    _cuda.check(_cuda.entry("conv_s8", "fbbev_conv_s8", 11, 0)(
        x.data_ptr(), w_k.data_ptr(), qp["scale"].data_ptr(),
        0 if b is None else b.data_ptr(),
        0 if m_x is None else m_x.data_ptr(),
        0 if m_x is not None else qp["s_x"].data_ptr(),
        y.data_ptr(), 0 if acc is None else acc.data_ptr(), w,
        w + c.part_at if c.plan.S > 1 else 0, ctypes.addressof(c.prm),
        # the current stream's pointer, without making a Stream object
        torch._C._cuda_getCurrentRawStream(x.get_device())), "conv_s8")
    return y, acc
