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
storage, i.e. in channels-last memory format.  The kernels read the
weights tap-major, relaid out by a small first kernel of the same launch
from w's own strides (for the input gradient with w's channels swapped
and its taps flipped).

CUDA kernel (``csrc/conv3x3.cu``), bf16: K6's implicit GEMM on Hopper's
TMA and ``wgmma`` (the ring, products and epilogue of
``csrc/tma_wgmma.cuh``).  A block computes the output pixels of one (TY,
TX) box of one image -- BM = TY * TX, 64 or 128 rows -- for BN (64, 128 or
256) output channels.  Each K step (one tap, 64 input channels) loads the
box shifted by the tap as one TMA tile, zero filled outside the image and
past Cin (the conv's padding), and the tap's weights relaid out to (9,
Cout, Cin) as another, through a 4-stage mbarrier ring into ``wgmma`` with
f32 accumulators.  Convs too small to fill the card split the K steps
into f32 partials, summed in a fixed order by a second pass.  The tile
plan is :func:`plan_bf16`'s, computed here and passed to the kernel as
ints.  f32: a CUDA-core kernel, for the checks.  Bound on the card:
operations (2 * N*H*W * 9*Cin*Cout on the bf16 tensor cores); the TPU's
stacked shifted copies of the input are not written.

Backward (:class:`Conv3x3`), as the TPU kernel's VJP: the input gradient
is the same convolution of the output gradient with the weights flipped in
(ky, kx) and transposed in (in, out) -- the same kernel on weights relaid
out so, so dgrad launches it too.  The weight gradient is the nine
shifted-input contractions, which the JAX package leaves to XLA (an f32
``einsum`` of bf16 operands): on bf16 card tensors one bf16 tensor-core
product per conv over the nine shifted row ranges stacked, f32
accumulation and an f32 result (:func:`_wgrad_bf16`; bf16 products are
exact in f32, so this is JAX's f32 einsum up to the order of the sums),
elsewhere nine f32 matrix products (:func:`_wgrad_f32`).

The plain version :func:`conv3x3_s1_plain` is the im2col formulation of
the TPU kernel: nine shifted f32 matrix products, summed, cast to x's
type.  CPU tensors take it; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from fbbev_tpu_torch.ops import _cuda
from fbbev_tpu_torch.ops.pallas_conv3d import SMS, modelled_time

launches = 0        # forward launches
dgrad_launches = 0  # input-gradient launches in the backward

# the K-step splits the plan considers (each must divide the conv's
# 9 * ceil(Cin / 64) K steps)
SPLITS = (1, 2, 3, 4, 6, 8, 9, 12, 18)

# K7's constants of the time model ``pallas_conv3d.modelled_time``: the
# seconds of one K step of the blocks of a (BM, BN) tile resident together
# on an SM (two where shared memory holds two), of a wave's pipeline fill
# and epilogue, and of the split-K second pass beyond its bytes.  A
# least-squares fit to the times of all 3940 plans at the flagship train
# step's shapes, forward and input gradient (``chip_smoke.py --k7-plans``
# on an H100 80GB HBM3 at 700 W: relative error median 0.076; a second
# sweep refitted them within 3%).
STEP_S = {(64, 64): 4.2766e-07, (64, 128): 5.4844e-07,
          (128, 64): 8.3690e-07, (128, 128): 5.1817e-07,
          (128, 256): 8.2257e-07}
WAVE_S = 1.0706e-06
SPLIT_S = 3.3390e-06


def supports(shape: Sequence[int], cout: int) -> bool:
    """The JAX routing gate (``pallas_conv.py:113-123``: a 3x3 stride-1
    SAME undilated conv with ``Cin % 64 == 0``, ``H >= 4``, ``W >= 8``) on
    an NCHW input shape, plus ``Cout % 16 == 0``: the dgrad launch takes
    Cout as its input channels and the kernel loads 16-channel groups."""
    _, cin, h, w = shape
    return cin % 64 == 0 and h >= 4 and w >= 8 and cout % 16 == 0


class Plan(NamedTuple):
    """The bf16 kernel's tiling of one conv: the A box is (TY, TX) output
    pixels of one image in a tile of BM >= TY * TX rows, BN output
    channels per block, the 9 * ceil(Cin / 64) K steps split into S equal
    ranges; the grid is (tiles_y * tiles_x, tiles_n, N * S)."""
    TY: int
    TX: int
    BM: int
    BN: int
    S: int
    tiles_y: int
    tiles_x: int
    tiles_n: int


def k_steps(Cin: int) -> int:
    """K steps of the bf16 kernel: 9 taps x ceil(Cin / 64) channel boxes."""
    return 9 * -(-Cin // 64)


def boxes(H: int, W: int, BM: int):
    """The output boxes (TY, TX) a BM-row tile may take on an H x W image:
    the powers of two with TY * TX = BM, and the boxes of more than BM / 2
    pixels that cut the image into equal parts (TY = ceil(H / ny), TX the
    widest ceil(W / nx) that fits), such as 5 x 25 of a 100 x 100 or 50 x
    50 image."""
    out = {(1 << k, BM >> k) for k in range(BM.bit_length())}
    for ny in range(1, H + 1):
        ty = -(-H // ny)
        if ty <= BM:
            tx = -(-W // -(-W // (BM // ty)))
            if 2 * ty * tx > BM:
                out.add((ty, tx))
    return sorted(out)


def plans_bf16(N: int, H: int, W: int, Cin: int, Cout: int,
               sms: int = SMS):
    """Every legal tile plan of the bf16 kernel for x (N, H, W, Cin) ->
    Cout, with its ranking key on a card of ``sms`` SMs (see
    :func:`plan_bf16`)."""
    if Cin % 16 or Cout % 16 or min(N, H, W, Cin, Cout) < 1:
        raise ValueError(f"no bf16 plan for N={N} H={H} W={W} Cin={Cin} "
                         f"Cout={Cout}")
    steps = k_steps(Cin)
    bns = (64,) if Cout <= 64 else (128,) if Cout <= 128 else (128, 256)
    out = []
    for BM in (128, 64):
        for BN in bns:
            if BN == 256 and BM != 128:
                continue
            tn = -(-Cout // BN)
            for ty, tx in boxes(H, W, BM):
                tyn, txn = -(-H // ty), -(-W // tx)
                blocks = N * tyn * txn * tn
                for S in SPLITS:
                    # split K only where the unsplit grid leaves SMs idle
                    if steps % S or (S > 1 and blocks >= sms):
                        continue
                    t = modelled_time(blocks, steps, BM, BN, S,
                                      N * H * W * Cout, sms, STEP_S, WAVE_S,
                                      SPLIT_S)
                    key = (round(t * 1e8), tyn * ty * txn * tx, -BM, S)
                    out.append((key, Plan(ty, tx, BM, BN, S, tyn, txn, tn)))
    return out


@functools.lru_cache(maxsize=256)
def plan_bf16(N: int, H: int, W: int, Cin: int, Cout: int,
              sms: int = SMS) -> Plan:
    """The tile plan of the bf16 kernel for x (N, H, W, Cin) -> Cout on a
    card of ``sms`` SMs: BN = 64 for Cout <= 64, 128 for Cout <= 128, else
    128 or 256 (with BM 128); over BM in (128, 64), BN, the boxes of
    :func:`boxes` and splits S of the K steps in :data:`SPLITS` (where the
    unsplit grid has fewer blocks than the card has SMs), the least
    ``pallas_conv3d.modelled_time`` with K7's fitted :data:`STEP_S`,
    :data:`WAVE_S` and :data:`SPLIT_S`.  Ties go to the smaller padded
    area, the larger BM, the smaller S."""
    return min(plans_bf16(N, H, W, Cin, Cout, sms))[1]


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


_sms = _cuda.sm_count


def _workspace(N: int, H: int, W: int, Cin: int, Cout: int, S: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The entries' workspace: the weights relaid out (9 * Cout * Cin of
    ``dtype``), then, for S > 1, the f32 split-K partials (S, N, H, W,
    Cout) at the next multiple of 256 bytes (``conv3x3.cu
    partials_offset``)."""
    wbytes = 9 * Cout * Cin * (2 if dtype == torch.bfloat16 else 4)
    nbytes = -(-wbytes // 256) * 256 + (4 * S * N * H * W * Cout if S > 1
                                        else 0)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _weight_args(w: torch.Tensor, dgrad: bool):
    """The strides (o, i, ky, kx) and flip of the conv's weights in w
    (Cout, Cin, 3, 3): w itself, or for the input gradient w with its
    channels swapped and its taps flipped (``w.flip(2, 3).transpose(0,
    1)``), which the entries' relayout kernel reads as such."""
    so, si, sy, sx = w.stride()
    return (si, so, sy, sx, 1) if dgrad else (so, si, sy, sx, 0)


def _launch_bf16(xh: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                 p: Plan, dgrad: bool) -> int:
    """Launch the bf16 relayout and kernel under plan ``p``: xh (N, H, W,
    Cin) and y (N, H, W, Cout) contiguous bf16 on the card, w bf16 (Cout,
    Cin, 3, 3) -- (Cin, Cout, 3, 3) with ``dgrad``, the conv then being
    with ``w.flip(2, 3).transpose(0, 1)``; returns the ``cudaError_t``."""
    N, H, W, Cin = xh.shape
    Cout = y.shape[-1]
    ws = _workspace(N, H, W, Cin, Cout, p.S, xh.dtype, xh.device)
    return _cuda.entry("conv3x3", "fbbev_conv3x3_bf16", 4, 15)(
        xh.data_ptr(), w.data_ptr(), y.data_ptr(), ws.data_ptr(), N, H, W,
        Cin, Cout, *_weight_args(w, dgrad), p.TY, p.TX, p.BM, p.BN, p.S,
        _cuda.stream_ptr(xh))


def _launch(x: torch.Tensor, w: torch.Tensor, dgrad: bool) -> torch.Tensor:
    """The kernel's conv of x (N, Cin, H, W) with w (Cout, Cin, 3, 3), or
    with ``dgrad`` with ``w.flip(2, 3).transpose(0, 1)``."""
    N, Cin, H, W = x.shape
    Cout = w.shape[1] if dgrad else w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and x.dtype != torch.float32:
        raise ValueError(f"x dtype {x.dtype}")
    if w.shape[2:] != (3, 3) or w.shape[0 if dgrad else 1] != Cin:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)}"
                         f"{' (input gradient)' if dgrad else ''}")
    if Cin % 16 or Cout % 16:
        raise ValueError(f"the kernel needs Cin and Cout multiples of 16: "
                         f"Cin={Cin} Cout={Cout}")
    if not w.is_cuda or w.device != x.device:
        raise ValueError("x and w must be on the same card")
    w = w.to(x.dtype)
    xh = x.permute(0, 2, 3, 1)
    if not xh.is_contiguous():
        xh = xh.contiguous()
    y = torch.empty(N, H, W, Cout, dtype=x.dtype, device=x.device)
    if bf16:
        if xh.data_ptr() % 16:
            # TMA reads 16-byte aligned tensors only; a channels-last view
            # at an odd offset (a z-slab of a padded volume) cannot be read
            raise ValueError(f"the bf16 kernel needs x's channels-last "
                             f"data 16-byte aligned: at "
                             f"{xh.data_ptr() % 16} bytes past")
        status = _launch_bf16(xh, w, y, plan_bf16(N, H, W, Cin, Cout,
                                                  _sms(x.device)), dgrad)
    else:
        ws = _workspace(N, H, W, Cin, Cout, 1, x.dtype, x.device)
        status = _cuda.entry("conv3x3", "fbbev_conv3x3_f32", 4, 10)(
            xh.data_ptr(), w.data_ptr(), y.data_ptr(), ws.data_ptr(), N, H,
            W, Cin, Cout, *_weight_args(w, dgrad), _cuda.stream_ptr(x))
    _cuda.check(status, "conv3x3")
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
    y = _launch(x, w, dgrad=False)
    launches += 1
    return y


def _dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient: the same convolution with w flipped in (ky, kx) and
    transposed in (in, out)."""
    if not g.is_cuda:
        return conv3x3_s1_plain(g, w.flip(2, 3).transpose(0, 1).to(g.dtype))
    global dgrad_launches
    dx = _launch(g, w, dgrad=True)
    dgrad_launches += 1
    return dx


def _wgrad_f32(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient: the nine (Cin, Cout) shifted-input contractions in
    f32 (``pallas_conv.py:146-152``), as (Cout, Cin, 3, 3)."""
    N, Cin, H, W = x.shape
    Cout = g.shape[1]
    xp = F.pad(x.permute(0, 2, 3, 1).float(), (0, 0, 1, 1, 1, 1))
    gm = g.permute(0, 2, 3, 1).float().reshape(-1, Cout)
    taps = [torch.matmul(xp[:, dy:dy + H, dx:dx + W].reshape(-1, Cin).t(),
                         gm) for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, Cin, Cout).permute(3, 2, 0, 1)


def im2col(x: torch.Tensor) -> torch.Tensor:
    """The nine shifted windows of x (N, C, H, W), zero-padded, side by
    side: (N * H * W, 9 * C), row (n, oy, ox), column (dy, dx, c) =
    x[n, c, oy + dy - 1, ox + dx - 1] (zero outside).  One 6-D strided
    view of the padded channels-last copy, copied once."""
    N, C, H, W = x.shape
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    sn, sy, sx, sc = xp.stride()
    view = xp.as_strided((N, H, W, 3, 3, C), (sn, sy, sx, sy, sx, sc),
                         xp.storage_offset())
    return view.reshape(N * H * W, 9 * C)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result: on the card one bf16 tensor-core product
    with f32 accumulation (``mm.dtype``; cuBLAS reduces in f32), on the
    CPU an f32 product of the same values."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


# pixels (rows) of one f32-summed product of the weight gradient
WGRAD_ROWS = 1 << 16


def _wgrad_bf16(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of bf16 x (N, Cin, H, W) and g (N, Cout, H, W) as
    (Cout, Cin, 3, 3) f32: the product (9 * Cin, N*H*W) x (N*H*W, Cout) of
    x's nine shifted windows side by side (:func:`im2col`, a copy of 9x
    the input) and g's pixels, the operands' own values with f32 sums, in
    slices of :data:`WGRAD_ROWS` pixels whose f32 results are summed in
    order.  On an H100 one product per conv ran at twice the speed of
    nine (Cin, Cout) products, one per tap, over the flagship train
    step's convs (``chip_smoke.py``, PERF.md); the tensor-core product's
    own f32 sums drift over a long reduction (VoVNet-99's stem at 6 x
    256x704, 1,081,344 pixels: past 1e-5 of the largest value), the
    slices keep them within it."""
    N, Cin, H, W = x.shape
    gm = g.permute(0, 2, 3, 1).reshape(N * H * W, -1)
    a = im2col(x)
    out = None
    for i in range(0, a.shape[0], WGRAD_ROWS):
        p = _mm_f32(a[i:i + WGRAD_ROWS].t(), gm[i:i + WGRAD_ROWS])
        out = p if out is None else out.add_(p)           # (9 * Cin, Cout)
    return out.reshape(3, 3, Cin, -1).permute(3, 2, 0, 1)


def _wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient in f32, (Cout, Cin, 3, 3): on bf16 tensor cores for
    bf16 card tensors, else in f32."""
    if x.is_cuda and x.dtype == g.dtype == torch.bfloat16:
        return _wgrad_bf16(x, g)
    return _wgrad_f32(x, g)


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
