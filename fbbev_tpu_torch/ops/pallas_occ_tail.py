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

CUDA kernel (``csrc/occ_tail.cu``, tail mode): one thread per output voxel
over all channels, the three lerps from up to 8 coarse neighbours per
level, the class product on the CUDA cores with the weights in shared
memory; it writes labels, and the bf16 logits only when asked (for the
checks).  It reads the port's ``(B, C, Y, X, Z)`` layout as it is --
neighbouring threads take neighbouring z, so full-resolution reads are
coalesced -- and makes no channels-last copy.  Bound on the card: bytes
(levels and weights read once, labels written once), about 0.04 ms on an
H100 SXM at the flagship.

The plain version is ``occ_tail_reference`` (``pallas_occ_tail.py:170``)
with the caller's upsamples: :func:`layers.upsample_int_axis` per axis.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from fbbev_tpu_torch.ops import _cuda

launches = 0

# the port's axes of (B, C, Y, X, Z) tensors
_Y, _X, _Z = 2, 3, 4


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
    if tuple(k2.shape) != (C, K) or not 1 <= K <= 32:
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
    blend (``out`` given)."""
    dt = levels[0].dtype
    B, C = levels[0].shape[:2]
    n = len(levels)
    Y, X, Z = w.shape[2:]
    if dt not in (torch.bfloat16, torch.float32) or not 1 <= n <= 4:
        raise ValueError(f"{n} levels of {dt}")
    if tuple(w.shape) != (B, n, Y, X, Z) or w.dtype != dt:
        raise ValueError(f"w {tuple(w.shape)} {w.dtype}")
    for lv in levels:
        if (lv.dtype != dt or tuple(lv.shape[:2]) != (B, C)
                or not int_factors([lv], (Y, X, Z))):
            raise ValueError(f"level {tuple(lv.shape)} {lv.dtype}")
        if not lv.is_cuda or lv.device != w.device:
            raise ValueError("every input must be on the same card")
    levels = [lv.contiguous() for lv in levels]
    w = w.contiguous()
    ptrs = (ctypes.c_void_p * n)(*[lv.data_ptr() for lv in levels])
    dims = (ctypes.c_int * (3 * n))(*[d for lv in levels
                                      for d in lv.shape[2:]])
    ptr = (lambda t: None if t is None else t.data_ptr())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.lib("occ_tail").fbbev_occ_tail
    fn.argtypes = [vp, vp, ci] + [vp] * 7 + [ci] * 8 + [vp]
    fn.restype = ci
    K = 0 if k2 is None else k2.shape[-1]
    _cuda.check(fn(ptrs, dims, n, w.data_ptr(), ptr(a), ptr(b), ptr(k2),
                   ptr(labels), ptr(logits), ptr(out),
                   int(dt == torch.bfloat16), int(labels is not None), B, C,
                   Y, X, Z, K, _cuda.stream_ptr(w)), "occ_tail")
