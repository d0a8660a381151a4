"""K8: the occupancy head's coarse-pred tail, from the four levels to
labels.

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_occ_tail.py:93 occ_tail``
(``_kernel`` :69, ``pl.pallas_call`` :146), the serving tail under
``FBBEV_OCC_TAIL=1`` (``occ_head.py:110-128``, ``_PredConvFused`` with
``tail_k2`` :240-269), together with the Z and Y upsamples its caller runs
before it and the argmax after it.  Function, per output voxel: each
level (``occ_pred_conv.0`` already applied at its own resolution) is
upsampled by integer factors with 2-tap lerps on Z, then Y, then X
(align_corners=False, edge clamp), blended with the softmax weights, put
through the folded eval BatchNorm affine ``a * v + b`` and relu, and
multiplied by the ``(C, K)`` class weights; the label is the first argmax
of the K logits.  Every op rounds to the levels' type where the JAX
package rounds (bf16 arithmetic with Python-float lerp weights; the class
product sums exact products in f32 and rounds once), so labels agree with
the plain version except at near-ties of f32 sums taken in another order.

CUDA kernel (``csrc/occ_tail.cu``, tail mode), planned by
:func:`plan_occ`: persistent blocks of 512 threads walk tiles of 8 x 8
output columns with the whole Z, 16 channels (one k16 slice) at a time.
Per chunk every level's clamped neighbourhood is copied to shared memory
once (``cp.async``, one chunk ahead) and upsampled separably -- Z, then Y
at coarse resolution in shared memory, X into registers -- in bf16 pairs
(``mul.rn`` / ``add.rn.bf16x2``, one rounding each, as the plain version
rounds).  A warp owns 4 z columns of 16 voxels as m16 tiles: each lane
blends, applies the affine and relu to its 2 voxels x 4 channels, which
are its A fragment of ``mma.sync.m16n8k16`` (bf16 in, f32 sums) against
the zero-padded class weights; the argmax of the bf16-rounded logits of
the classes < K runs across the quad's lanes.  It writes labels, and the
logits only when asked (for the checks).  The f32 instantiation keeps a
CUDA-core product.  Bound on the card: bytes (levels and weights read
once, labels written once), about 0.031 ms on an H100 SXM at the
flagship.

The plain version is ``occ_tail_reference`` (``pallas_occ_tail.py:170``)
with the caller's upsamples: :func:`layers.upsample_int_axis` per axis.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from fbbev_tpu_torch.ops import _cuda

launches = 0

# the port's axes of (B, C, Y, X, Z) tensors
_Y, _X, _Z = 2, 3, 4

# constants of csrc/occ_tail.cu (tests/test_torch_occ.py holds them equal)
BLEND_THREADS = 256  # kBlendThreads
TAIL_THREADS = 512   # kTailThreads
TAIL_WARPS = TAIL_THREADS // 32
MAX_LEVELS = 4       # kMaxLevels
MAX_K = 32           # kMaxK
ZV = 8               # kZV: z values per thread in the blend's last pass
MT = 4               # kMT: m16 tiles (z columns) per warp in the tail
TAIL_CC = 16         # kTailCC: channels per chunk in the tail (k16)
SCRATCH_LD = 17      # kScratchLd: row stride of the f32 tail's h tile
TAP_BYTES = 16       # sizeof(Tap)
PLAN_HEAD, PLAN_LEVEL = 13, 6  # kPlanHead, kPlanLevel
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on an H100
MIN_BLOCKS = 1024    # the blend splits C into groups up to this many tiles


class OccLevel(NamedTuple):
    """One level's part of an :class:`OccPlan`: factors, staged rows and
    columns, and shared byte offsets (``s0`` < 0: read from global memory;
    ``s1`` / ``s2`` < 0: the buffer before, its axis skipped)."""
    f: Tuple[int, int, int]
    sy: int
    sx: int
    s0: int
    s1: int
    s2: int
    tap: int


class OccPlan(NamedTuple):
    """A launch of ``occ_tail.cu``: tiles of TY x TX output columns (all
    of Z), CC channels per chunk, the channels split into ``groups`` of
    ``chunks`` chunks (blend only), the shared-memory layout and the tile
    grid (tiles along X, tiles along Y, B * groups), which the kernel's
    persistent blocks walk."""
    TY: int
    TX: int
    CC: int
    chunks: int
    groups: int
    smem: int
    k2off: int
    aoff: int
    boff: int
    scratch: int
    woff: int
    grid: Tuple[int, int, int]
    levels: Tuple[OccLevel, ...]

    def ints(self) -> list:
        """The plan as the kernel's entry takes it."""
        head = [self.TY, self.TX, self.CC, self.chunks, self.groups,
                self.smem, self.k2off, self.aoff, self.boff, self.scratch,
                self.grid[0], self.grid[1], self.woff]
        return head + [v for lv in self.levels
                       for v in (lv.sy, lv.sx, lv.s0, lv.s1, lv.s2, lv.tap)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def r8(n: int) -> int:
    return _cdiv(n, 8) * 8


def span(t: int, f: int) -> int:
    """Coarse rows a tile of ``t`` output rows needs at factor ``f``: the
    taps of every tile origin (a multiple of t) with one halo row each
    side; t itself at factor 1 (no lerp)."""
    return t if f == 1 else (f - math.gcd(t, f) + t - 1) // f + 3


def span_lo(t0: int, f: int) -> int:
    """The first coarse index staged for a tile starting at ``t0``."""
    return t0 if f == 1 else t0 // f - 1


def tap(o: int, f: int, n: int, lo: int = 0):
    """Output coordinate ``o``'s 2-tap lerp at factor ``f`` over ``n``
    coarse cells: (i0, i1, w1) with indices local to the span starting at
    ``lo`` (the kernel's ``make_tap``; w0 = 1 - w1 before rounding)."""
    if f == 1:
        return o - lo, o - lo, 0.0
    i, k = divmod(o, f)
    c = (k + 0.5) / f - 0.5
    if c < 0:
        return max(i - 1, 0) - lo, i - lo, c + 1.0
    return i - lo, min(i + 1, n - 1) - lo, c


def pad_ch(n: int, itemsize: int) -> int:
    """A channel stride of ``n`` elements padded to 4 (mod 32) words, so
    the channels 2t (and 2t + 1), t < 4, that a warp of the tail's last
    pass reads at once fall into distinct banks (the kernel's
    ``pad_ch``)."""
    w = n * itemsize // 4
    return (w + ((4 - w) & 31)) * 4 // itemsize


def buffer_strides(f, nz: int, sy: int, sx: int, TY: int, Zp: int,
                   tail: bool, itemsize: int) -> Tuple[int, int, int]:
    """Channel strides (elements) of a level's buffers S0 [sy][r8(sx *
    cz)], S1 and S2 [TY][sx * Zp] (S1 [sy][sx * Zp] in the tail, [TY][r8(sx
    * cz)] in the blend), as the kernel's ``bufs``."""
    rs0 = r8(sx * (Zp if f[2] == 1 else nz))
    rs2 = sx * Zp
    return (pad_ch(sy * rs0, itemsize),
            pad_ch(sy * rs2 if tail else TY * rs0, itemsize),
            pad_ch(TY * rs2, itemsize))


def plan_occ(B: int, C: int, Y: int, X: int, Z: int,
             dims: Sequence[Tuple[int, int, int]], tail: bool,
             itemsize: int, K: int = 0) -> OccPlan:
    """The launch of ``occ_tail.cu`` for levels of (Yi, Xi, Zi) ``dims``.

    Blend: 256 threads own 8 z values each, so a tile is TX = 16 columns
    wide and 256 / (16 * ceil(Z / 8)) rows high (8 x 16 at Z = 16); chunks
    of 8 bf16 (4 f32) channels; the channels split into groups until the
    grid has ``MIN_BLOCKS`` blocks.  Tail: 1024 threads, a warp a z column
    of 16 voxels, so a tile of 32 / ceil(Z / 16) columns (4 x 8 at Z =
    16); chunks of 16 channels, one group.  Where the layout passes the
    card's shared memory the tile loses rows (then columns) until it fits
    (the f32 tail: 2 x 8); ``ValueError`` if none does."""
    Zp = r8(Z)
    if tail:
        if not 1 <= K <= MAX_K:
            raise ValueError(f"K={K} classes: the kernel takes 1..{MAX_K}")
        cols = TAIL_WARPS * MT // _cdiv(Z, 16)
        if cols < 1:
            raise ValueError(f"Z={Z}: a z column needs more than "
                             f"{TAIL_WARPS * MT} m16 tiles")
        TX = min(8, cols)
        TY = cols // TX
        CC = TAIL_CC
    else:
        zg = _cdiv(Z, ZV)
        if zg > BLEND_THREADS:
            raise ValueError(f"Z={Z}: more than {BLEND_THREADS * ZV}")
        TX = min(16, BLEND_THREADS // zg)
        TY = BLEND_THREADS // (TX * zg)
        CC = 8 if itemsize == 2 else 4
    while True:
        plan = _layout(B, C, Y, X, Z, dims, tail, itemsize, K, TY, TX, CC)
        if plan.smem <= SMEM_LIMIT:
            return plan
        if TY == TX == 1:
            raise ValueError(f"occ_tail needs {plan.smem} bytes of shared "
                             f"memory, over the card's {SMEM_LIMIT}")
        TY, TX = (TY // 2, TX) if TY > 1 else (TY, TX // 2)


def _layout(B, C, Y, X, Z, dims, tail, itemsize, K, TY, TX, CC) -> OccPlan:
    """:func:`plan_occ`'s grid and shared-memory layout for one tile."""
    Zp = r8(Z)
    nchunks = _cdiv(C, CC)
    tiles = _cdiv(Y, TY) * _cdiv(X, TX)
    groups = 1 if tail else min(nchunks, max(1, _cdiv(MIN_BLOCKS,
                                                      tiles * B)))
    chunks = _cdiv(nchunks, groups)
    groups = _cdiv(nchunks, chunks)
    off = 0

    def take(nbytes: int) -> int:
        nonlocal off
        o, off = off, off + _cdiv(nbytes, 16) * 16
        return o

    k2off = aoff = boff = scratch = woff = 0
    if tail:   # class weights, BN affine, the tile's blend weights
        Cp, Kp = _cdiv(C, 16) * 16, _cdiv(K, 8) * 8
        k2off = take(Kp * Cp * itemsize)
        aoff = take(Cp * itemsize)
        boff = take(Cp * itemsize)
        woff = take(len(dims) * TY * TX * Zp * itemsize)
        if itemsize == 4:
            scratch = take(TAIL_WARPS * 16 * SCRATCH_LD * 4)
    levels = []
    for ny, nx, nz in dims:
        f = (Y // ny, X // nx, Z // nz)
        if f == (1, 1, 1) and not tail:   # read from global memory
            levels.append(OccLevel(f, 0, 0, -1, -1, -1, -1))
            continue
        fy, fx, fz = f
        sy, sx = span(TY, fy), span(TX, fx)
        chs0, chs1, chs2 = buffer_strides(f, nz, sy, sx, TY, Zp, tail,
                                          itemsize)
        t = take((TY + TX + Zp) * TAP_BYTES)
        s0 = take(2 * CC * chs0 * itemsize)   # one copy per chunk parity
        first, second = (fz, fy) if tail else (fy, fz)
        s1 = take(CC * chs1 * itemsize) if first > 1 else -1
        s2 = take(CC * chs2 * itemsize) if second > 1 else -1
        levels.append(OccLevel(f, sy, sx, s0, s1, s2, t))
    return OccPlan(TY, TX, CC, chunks, groups, off, k2off, aoff, boff,
                   scratch, woff, (_cdiv(X, TX), _cdiv(Y, TY), B * groups),
                   tuple(levels))


def int_factors(levels: Sequence[torch.Tensor], target: Sequence[int]
                ) -> bool:
    """Every level's (Y, X, Z) divides ``target`` (the JAX ``_tail_ok``
    shape gate, ``occ_head.py:169-172``)."""
    return all(s and t % s == 0 for lv in levels
               for s, t in zip(lv.shape[2:], target))


def upsample(levels: Sequence[torch.Tensor], target: Sequence[int],
             axes: Sequence[int]) -> list:
    """Each level upsampled to ``target`` (Y, X, Z) by
    :func:`layers.upsample_int_axis`, axis by axis in the order ``axes``."""
    from fbbev_tpu_torch.models.layers import upsample_int_axis
    out = []
    for v in levels:
        for ax in axes:
            size = target[ax - 2]
            if v.shape[ax] != size:
                v = upsample_int_axis(v, ax, size // v.shape[ax])
        out.append(v)
    return out


def blend(levels: Sequence[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
    """sum_i levels[i] * w[:, i], in the levels' type, in level order."""
    acc = None
    for i, v in enumerate(levels):
        t = v * w[:, i:i + 1]
        acc = t if acc is None else acc + t
    return acc


def occ_tail_plain(levels, w, a, b, k2, return_logits: bool = False):
    """Plain version; arguments and results as :func:`occ_tail`."""
    dt = levels[0].dtype
    up = upsample(levels, w.shape[2:], (_Z, _Y, _X))
    acc = blend(up, w)
    c = (slice(None),) + (None,) * 3
    h = torch.relu(acc * a.to(dt)[c] + b.to(dt)[c])
    logits = (h.permute(0, 2, 3, 4, 1).float()
              @ k2.to(dt).float()).to(dt)
    labels = logits.float().argmax(-1)
    return (labels, logits) if return_logits else labels


def occ_tail(levels: Sequence[torch.Tensor], w: torch.Tensor,
             a: torch.Tensor, b: torch.Tensor, k2: torch.Tensor,
             return_logits: bool = False):
    """Labels of the fused tail.

    Args:
      levels: up to four (B, C, Yi, Xi, Zi) tensors, bf16 or f32, each
        (Yi, Xi, Zi) dividing (Y, X, Z).
      w: (B, n, Y, X, Z) blend weights, the levels' type.
      a, b: (C,) eval BatchNorm affine (``scale * rsqrt(var + eps)``,
        ``bias - mean * a``).  k2: (C, K) class weights, K <= 32.

    Returns (B, Y, X, Z) int64 labels, and with ``return_logits`` also the
    (B, Y, X, Z, K) logits in the levels' type.  CUDA tensors launch the
    kernel; CPU tensors take the plain version.  No backward.
    """
    _cuda.refuse_grad("occ_tail (K8)", *levels, w, a, b, k2)
    if not levels[0].is_cuda:
        return occ_tail_plain(levels, w, a, b, k2, return_logits)
    global launches
    dt = levels[0].dtype
    B, C = levels[0].shape[:2]
    Y, X, Z = w.shape[2:]
    K = k2.shape[-1]
    if tuple(k2.shape) != (C, K) or not 1 <= K <= MAX_K:
        raise ValueError(f"k2 {tuple(k2.shape)} for C={C}")
    labels = torch.empty(B, Y, X, Z, dtype=torch.int64, device=w.device)
    logits = (torch.empty(B, Y, X, Z, K, dtype=dt, device=w.device)
              if return_logits else None)
    rnd = (lambda t: t.to(dt).float().contiguous())
    _launch(levels, w, labels, logits, None, rnd(a), rnd(b), rnd(k2))
    launches += 1
    return (labels, logits) if return_logits else labels


def _launch(levels, w, labels: Optional[torch.Tensor],
            logits: Optional[torch.Tensor], out: Optional[torch.Tensor],
            a=None, b=None, k2=None) -> None:
    """One launch of ``occ_tail.cu``: the tail (``labels`` given) or the
    blend (``out`` given), planned by :func:`plan_occ`."""
    dt = levels[0].dtype
    B, C = levels[0].shape[:2]
    n = len(levels)
    Y, X, Z = w.shape[2:]
    if dt not in (torch.bfloat16, torch.float32) or not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"{n} levels of {dt}")
    if tuple(w.shape) != (B, n, Y, X, Z) or w.dtype != dt:
        raise ValueError(f"w {tuple(w.shape)} {w.dtype}")
    for lv in levels:
        if (lv.dtype != dt or tuple(lv.shape[:2]) != (B, C)
                or not int_factors([lv], (Y, X, Z))):
            raise ValueError(f"level {tuple(lv.shape)} {lv.dtype}")
        if not lv.is_cuda or lv.device != w.device:
            raise ValueError("every input must be on the same card")
    K = 0 if k2 is None else k2.shape[-1]
    plan = plan_occ(B, C, Y, X, Z, [tuple(lv.shape[2:]) for lv in levels],
                    labels is not None, levels[0].element_size(), K)
    # 16-byte aligned bases: the kernel's vector loads and cp.async
    aligned = (lambda t: t if t.data_ptr() % 16 == 0 else t.clone())
    levels = [aligned(lv.contiguous()) for lv in levels]
    w = aligned(w.contiguous())
    ptrs = (ctypes.c_void_p * n)(*[lv.data_ptr() for lv in levels])
    dims = (ctypes.c_int * (3 * n))(*[d for lv in levels
                                      for d in lv.shape[2:]])
    ints = plan.ints()
    cplan = (ctypes.c_int * len(ints))(*ints)
    ptr = (lambda t: None if t is None else t.data_ptr())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.lib("occ_tail").fbbev_occ_tail
    fn.argtypes = [vp, vp, ci] + [vp] * 7 + [ci] * 8 + [vp, vp]
    fn.restype = ci
    _cuda.check(fn(ptrs, dims, n, w.data_ptr(), ptr(a), ptr(b), ptr(k2),
                   ptr(labels), ptr(logits), ptr(out),
                   int(dt == torch.bfloat16), int(labels is not None), B, C,
                   Y, X, Z, K, cplan, _cuda.stream_ptr(w)), "occ_tail")
