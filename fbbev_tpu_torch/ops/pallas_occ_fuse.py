"""K9: multi-scale upsample and softmax blend of the occ head's levels.

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_occ_fuse.py:80
fuse_multiscale`` (``_kernel`` :64, ``pl.pallas_call`` :124), the eval
blend under ``FBBEV_OCCFUSE=1`` (``occ_head.py:174-216``: with C % 128 ==
0, so at the flagship only with ``FBBEV_OCC_COARSE_PRED=0``, where the
four 128-channel levels are blended before ``occ_pred_conv``), together
with the Y upsample its caller runs before it.  Function: each level
upsampled by integer factors with 2-tap lerps (align_corners=False, edge
clamp) and the levels summed with the per-voxel weights, ``sum_i
up(levels[i]) * w[:, i]``, in the levels' type.  The rounding follows the
JAX path: Y upsampled first (outside the TPU kernel), then Z and X (inside
it), every op rounded to the levels' type.

CUDA kernel: the blend mode of K8's ``csrc/occ_tail.cu``, planned by
``pallas_occ_tail.plan_occ``: tiles of 8 x 16 output columns with the
whole Z, 8 channels a chunk, the channels split into groups until there
are 1024 tiles; persistent blocks of 256 threads.  Each coarse level's
clamped neighbourhood is copied to shared memory once a chunk
(``cp.async``, one chunk ahead) and upsampled separably -- Y, then Z at
coarse resolution, X into registers -- in bf16 pairs with one rounding
per op, so the result is the plain version's bit for bit; level 0 is
read from global memory, and a thread blends and stores 8 z values of a
column with 16-byte loads and stores.  Bound on the card: bytes (levels
and weights read once, the 128-channel blend written once), about 0.11
ms on an H100 SXM at the flagship.

The plain version is ``_fuse_levels``' XLA expression (``occ_head.py:
211-216``: upsample, then one weighted sum) taken in the TPU kernel's
rounding order, :func:`layers.upsample_int_axis` per axis.
"""

from __future__ import annotations

from typing import Sequence

import torch

from fbbev_tpu_torch.ops import _cuda
from fbbev_tpu_torch.ops.pallas_occ_tail import _Y, _X, _Z, _launch, \
    blend, upsample

launches = 0


def fuse_multiscale_plain(levels: Sequence[torch.Tensor], w: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version; arguments and result as :func:`fuse_multiscale`."""
    return blend(upsample(levels, w.shape[2:], (_Y, _Z, _X)), w)


def fuse_multiscale(levels: Sequence[torch.Tensor], w: torch.Tensor
                    ) -> torch.Tensor:
    """Blend up to four (B, C, Yi, Xi, Zi) levels, each (Yi, Xi, Zi)
    dividing (Y, X, Z), with the (B, n, Y, X, Z) weights: (B, C, Y, X, Z)
    in the levels' type (bf16 or f32; ``w`` of the same type).  CUDA
    tensors launch the kernel; CPU tensors take the plain version.  No
    backward."""
    _cuda.refuse_grad("fuse_multiscale (K9)", *levels, w)
    if not levels[0].is_cuda:
        return fuse_multiscale_plain(levels, w)
    global launches
    B, C = levels[0].shape[:2]
    out = torch.empty(B, C, *w.shape[2:], dtype=levels[0].dtype,
                      device=w.device)
    _launch(levels, w, None, None, out)
    launches += 1
    return out
