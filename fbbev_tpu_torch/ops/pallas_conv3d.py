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
are relaid out to (27, Cout, Cin) for the bf16 kernel (K-major tiles of
its weight operand) and to the JAX package's (3, 3, 3, Cin, Cout) for the
f32 one.

CUDA kernel (``csrc/conv3d.cu``), bf16: an implicit GEMM on Hopper's TMA
and ``wgmma``.  A block computes the output voxels of one (TY, TX, Z')
box -- Z' is Z rounded up to a power of two, TY * TX * Z' = BM, 64 or 128
rows -- for BN (64, 128 or 256) output channels.  Each K step (one tap, 64
input channels) loads the box shifted by the tap as one TMA tile, zero
filled outside the volume (the conv's padding), and the tap's weights
relaid out to (27, Cout, Cin) as another, through a 4-stage mbarrier ring
into ``wgmma`` with f32 accumulators.  Volumes too small to fill the card
split K over tap ranges into f32 partials, summed in a fixed order by a
second pass.  The tile plan is :func:`plan_bf16`'s, computed here and
passed to the kernel as ints.  f32: a CUDA-core kernel, for the checks.
Bound on the card: operations (2 * voxels * 27 * Cin * Cout on the bf16
tensor cores).

The plain version :func:`conv3d_3x3x3_plain` is ``F.conv3d`` in f32
(cuDNN's TF32 off), cast to x's type, as :func:`pallas_conv.
conv3x3_s1_plain` is K7's.  CPU tensors take it; CUDA tensors launch the
kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

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


SMS = 132                       # streaming multiprocessors, H100 SXM
TC_PER_SM = 989e12 / SMS        # bf16 tensor-core FLOP/s per SM
L2_PER_SM = 80e9                # L2 -> shared memory bytes/s of one SM
HBM_BPS = 3.35e12
SMEM_PER_SM = 232448            # shared memory the blocks of an SM use
STAGES = 4                      # tma_wgmma.cuh kStages


class Plan(NamedTuple):
    """The bf16 kernel's tiling of one conv: the A box is (TY, TX, Zp)
    output voxels (BM = TY * TX * Zp rows), BN output channels per block,
    K split over S tap ranges; the grid is (tiles_y * tiles_x, tiles_n,
    B * S)."""
    Zp: int
    TY: int
    TX: int
    BM: int
    BN: int
    S: int
    tiles_y: int
    tiles_x: int
    tiles_n: int


def smem_bytes(BM: int, BN: int) -> int:
    """``Ring<BM / 64, BN>::kSmem`` of ``csrc/tma_wgmma.cuh``: the ring,
    1024 bytes of alignment slack, the barriers."""
    return STAGES * (BM + BN) * 128 + 1024 + 2 * STAGES * 8


def _step_s(BM: int, BN: int) -> float:
    """K6's K step time for the blocks of a BM x BN tile resident on an SM:
    the longer of their products on the SM's tensor cores and their A and
    B tiles from L2 at ~80 GB/s per SM."""
    slots = min(2, SMEM_PER_SM // smem_bytes(BM, BN))
    return slots * max(BM * BN * 128 / TC_PER_SM,
                       (BM + BN) * 128 / L2_PER_SM)


# K6's constants of :func:`modelled_time` (K7's are its own, fitted)
STEP_S = {(bm, bn): _step_s(bm, bn) for bm in (64, 128)
          for bn in (64, 128, 256) if bn < 256 or bm == 128}
WAVE_S = 2.5e-6
SPLIT_S = 3e-6


def modelled_time(blocks: int, steps: int, BM: int, BN: int, S: int,
                  out_elems: int, sms: int = SMS, step_s=None,
                  wave_s: float = WAVE_S, split_s: float = SPLIT_S) -> float:
    """Seconds the TMA / ``wgmma`` implicit GEMM of ``tma_wgmma.cuh`` (K6,
    K7) is modelled to take for ``blocks`` BM x BN output tiles of
    ``steps`` K steps (64 channels of one tap), split S ways, with
    ``out_elems`` outputs: waves of blocks (as many resident per SM as
    shared memory holds, at most two) times a block's K steps at
    ``step_s[BM, BN]`` (K6's :data:`STEP_S` by default) plus a wave's
    fixed ``wave_s`` (pipeline fill, epilogue); a split adds its f32
    partials through HBM (written, then read by the second pass, which
    writes bf16) and ``split_s``."""
    slots = min(2, SMEM_PER_SM // smem_bytes(BM, BN))
    waves = -(-blocks * S // (sms * slots))
    t = waves * (steps // S * (step_s or STEP_S)[BM, BN] + wave_s)
    if S > 1:
        t += (8 * S + 2) * out_elems / HBM_BPS + split_s
    return t


def plans_bf16(B: int, Y: int, X: int, Z: int, Cin: int, Cout: int,
               sms: int = SMS):
    """Every legal tile plan of the bf16 kernel for x (B, Y, X, Z, Cin) ->
    Cout, with its ranking key on a card of ``sms`` SMs (see
    :func:`plan_bf16`)."""
    if Cin % 64 or Cout % 16 or not 1 <= Z <= 32 or min(B, Y, X) < 1:
        raise ValueError(f"no bf16 plan for B={B} Y={Y} X={X} Z={Z} "
                         f"Cin={Cin} Cout={Cout}")
    Zp = 1 << (Z - 1).bit_length()
    bns = (64,) if Cout <= 64 else (128,) if Cout <= 128 else (128, 256)
    out = []
    for BM in (128, 64):
        for BN in bns:
            if BN == 256 and BM != 128:
                continue
            tn = -(-Cout // BN)
            area = BM // Zp
            ty = 1
            while ty <= area:
                tx = area // ty
                tyn, txn = -(-Y // ty), -(-X // tx)
                blocks = B * tyn * txn * tn
                for S in (1, 3, 9):
                    t = modelled_time(blocks, 27 * (Cin // 64), BM, BN, S,
                                      B * Y * X * Z * Cout, sms)
                    key = (round(t * 1e8), tyn * ty * txn * tx, -BM, S)
                    out.append((key, Plan(Zp, ty, tx, BM, BN, S, tyn, txn,
                                          tn)))
                ty *= 2
    return out


@functools.lru_cache(maxsize=256)
def plan_bf16(B: int, Y: int, X: int, Z: int, Cin: int, Cout: int,
              sms: int = SMS) -> Plan:
    """The tile plan of the bf16 kernel for x (B, Y, X, Z, Cin) -> Cout on a
    card of ``sms`` SMs.  Zp = Z rounded up to a power of two; BN = 64 for
    Cout <= 64, 128 for Cout <= 128, else 128 or 256 (with BM 128).  Over
    BM in (128, 64), BN, box edges TY, TX (powers of two, TY * TX * Zp =
    BM) and splits S in (1, 3, 9), the least :func:`modelled_time` (its L2
    rate the one that fits the kernel's times at the flagship shapes on an
    H100 SXM, ``chip_smoke.py --k6-plans``: a step of 128 x 128 tiles
    takes ~0.41 us, of 128 x 256 ~0.67 us).
    Ties go to the smaller padded volume, the larger BM, the smaller S.
    Wide tiles win: at 50x50x4 a 91-block grid of 128 x 256 tiles beats
    every grid that fills the 132 SMs, while the 25x25x2 volumes split."""
    return min(plans_bf16(B, Y, X, Z, Cin, Cout, sms))[1]


_sms = _cuda.sm_count


def _launch_bf16(xh: torch.Tensor, wk: torch.Tensor, y: torch.Tensor,
                 p: Plan) -> int:
    """Launch the bf16 kernel under plan ``p``: xh (B, Y, X, Z, Cin), wk
    (27, Cout, Cin), y (B, Y, X, Z, Cout), all contiguous bf16 on the card;
    returns the ``cudaError_t``."""
    B, Y, X, Z, Cin = xh.shape
    Cout = y.shape[-1]
    ws = (torch.empty(p.S, B, Y, X, Z, Cout, dtype=torch.float32,
                      device=xh.device) if p.S > 1 else None)
    return _cuda.entry("conv3d", "fbbev_conv3d_bf16", 4, 12)(
        xh.data_ptr(), wk.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), B, Y, X, Z, Cin, Cout, p.Zp,
        p.TY, p.TX, p.BM, p.BN, p.S, _cuda.stream_ptr(xh))


def conv3d_3x3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, Cin, Y, X, Z), w (Cout, Cin, 3, 3, 3) ->
    (B, Cout, Y, X, Z) in x's type, f32 accumulation."""
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        y = F.conv3d(x.float(), w.float(), padding=1)
    return y.to(x.dtype)


def conv3d_3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The convolution (no gradient): CUDA tensors launch the kernel (bf16
    with Cin a multiple of 64, or f32 with Cin a multiple of 16; Cout a
    multiple of 16, 1 <= Z <= 32), CPU tensors take the plain version.
    Shapes as :func:`conv3d_3x3x3_plain`."""
    _cuda.refuse_grad("conv3d_3x3x3 (K6)", x, w)
    if not x.is_cuda:
        return conv3d_3x3x3_plain(x, w)
    global launches
    B, Cin, Y, X, Z = x.shape
    Cout = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and x.dtype != torch.float32:
        raise ValueError(f"x dtype {x.dtype}")
    if tuple(w.shape) != (Cout, Cin, 3, 3, 3):
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if Cin % (64 if bf16 else 16) or Cout % 16 or not 1 <= Z <= 32:
        raise ValueError(f"the kernel needs Cin a multiple of "
                         f"{64 if bf16 else 16}, Cout of 16 and 1 <= Z <= "
                         f"32: Cin={Cin} Cout={Cout} Z={Z} ({x.dtype})")
    if not w.is_cuda or w.device != x.device:
        raise ValueError("x and w must be on the same card")
    xh = x.permute(0, 2, 3, 4, 1).contiguous()
    if xh.data_ptr() % 16:          # TMA takes 16-byte aligned tensors
        xh = xh.clone()
    y = torch.empty(B, Y, X, Z, Cout, dtype=x.dtype, device=x.device)
    if bf16:
        wk = w.to(x.dtype).permute(2, 3, 4, 0, 1).reshape(
            27, Cout, Cin).contiguous()
        status = _launch_bf16(xh, wk, y, plan_bf16(B, Y, X, Z, Cin, Cout,
                                                   _sms(x.device)))
    else:
        wk = w.permute(2, 3, 4, 1, 0).contiguous()
        status = _cuda.entry("conv3d", "fbbev_conv3d_f32", 3, 6)(
            xh.data_ptr(), wk.data_ptr(), y.data_ptr(), B, Y, X, Z, Cin,
            Cout, _cuda.stream_ptr(x))
    _cuda.check(status, "conv3d")
    launches += 1
    return y.permute(0, 4, 1, 2, 3)
