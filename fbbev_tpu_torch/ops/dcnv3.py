"""DCNv3 core op (InternImage's deformable convolution v3).  Counterpart
of ``fbbev_tpu/ops/dcnv3.py``: grouped K-point deformable sampling with
per-point (already softmaxed) masks over a strided / padded / dilated
output grid.  A sampling location is the output pixel's reference point
in the padded input plus the dilated kernel grid scaled by
``offset_scale`` plus the learned offset normalised by the padded size;
bilinear, ``align_corners=False``, zero outside.

* K is ordered x-major (``k = ix * kh + iy``), the reference's
  ``_generate_dilation_grids``, so InternImage checkpoints map 1:1.
* H is padded by ``pad[0]`` and W by ``pad[1]`` (the reference's CUDA
  kernel; its debug PyTorch version swaps them, harmless for its square
  configs).

Plain PyTorch on :func:`grid_sample.grid_sample_2d`; its gradient comes
from autograd.  Neither package's models call it (the JAX package has no
kernel for it), so it has no CUDA kernel here either."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from fbbev_tpu_torch.ops.grid_sample import grid_sample_2d

_IntPair = Union[int, Tuple[int, int]]


def _pair(v: _IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _resolve(kernel, stride, pad, dilation):
    kh, kw = _pair(kernel)
    dh, dw = _pair(dilation)
    if pad is None:
        pad = ((dh * (kh - 1)) // 2, (dw * (kw - 1)) // 2)
    return (kh, kw), _pair(stride), _pair(pad), (dh, dw)


def dcnv3_output_size(in_size: Tuple[int, int], kernel: _IntPair = (3, 3),
                      stride: _IntPair = 1, pad: Optional[_IntPair] = None,
                      dilation: _IntPair = 1) -> Tuple[int, int]:
    """(H_out, W_out) of a DCNv3 config: conv arithmetic on the padded
    input; ``pad=None`` is SAME for stride 1."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = _resolve(kernel, stride, pad,
                                                      dilation)
    H_, W_ = in_size[0] + 2 * ph, in_size[1] + 2 * pw
    return ((H_ - (dh * (kh - 1) + 1)) // sh + 1,
            (W_ - (dw * (kw - 1) + 1)) // sw + 1)


def dcnv3_core(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               kernel: _IntPair = (3, 3), stride: _IntPair = 1,
               pad: Optional[_IntPair] = None, dilation: _IntPair = 1,
               groups: int = 4, offset_scale: float = 1.0) -> torch.Tensor:
    """x (B, H, W, C) value features; offset (B, H_out, W_out, G*K*2)
    pixel offsets, (x, y) interleaved last, in the reference's K order;
    mask (B, H_out, W_out, G*K), softmaxed over K per group.  Returns (B,
    H_out, W_out, C).  The coordinates are computed in the offsets' type
    (at least float32)."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = _resolve(kernel, stride, pad,
                                                      dilation)
    B, H, W, C = x.shape
    K, G = kh * kw, groups
    Cg = C // G
    H_, W_ = H + 2 * ph, W + 2 * pw
    Ho, Wo = dcnv3_output_size((H, W), (kh, kw), (sh, sw), (ph, pw),
                               (dh, dw))
    if tuple(offset.shape[1:3]) != (Ho, Wo):
        raise ValueError(
            f"offset spatial shape {tuple(offset.shape[1:3])} != computed "
            f"output ({Ho}, {Wo}) for input ({H}, {W}) kernel ({kh}, {kw}) "
            f"stride ({sh}, {sw}) pad ({ph}, {pw}) dilation ({dh}, {dw})")
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    cdt = torch.promote_types(offset.dtype, torch.float32)
    dev = x.device

    def ar(n):
        return torch.arange(n, dtype=cdt, device=dev)

    # reference points: strided output-pixel centres of the dilated
    # kernel in the padded input, in [0, 1]
    ry = ((dh * (kh - 1)) // 2 + 0.5 + ar(Ho) * sh) / H_
    rx = ((dw * (kw - 1)) // 2 + 0.5 + ar(Wo) * sw) / W_
    gry, grx = torch.meshgrid(ry, rx, indexing="ij")
    ref = torch.stack([grx, gry], -1)                         # (Ho, Wo, 2)
    # the dilated kernel grid, x-major, normalised by the padded size
    gx = -((dw * (kw - 1)) // 2) + ar(kw) * dw
    gy = -((dh * (kh - 1)) // 2) + ar(kh) * dh
    gxx, gyy = torch.meshgrid(gx, gy, indexing="ij")          # (kw, kh)
    grid = torch.stack([gxx / W_, gyy / H_], -1).reshape(K, 2)
    off = offset.to(cdt).reshape(B, Ho, Wo, G, K, 2)
    norm = torch.tensor([W_, H_], dtype=cdt, device=dev)
    loc = (ref[None, :, :, None, None] + grid * offset_scale
           + off * (offset_scale / norm))             # (B, Ho, Wo, G, K, 2)
    # sample each group over the padded input: value (B*G, H_, W_, Cg),
    # grid (B*G, Ho*Wo, K, 2) in [-1, 1]
    v = xp.reshape(B, H_, W_, G, Cg).permute(0, 3, 1, 2, 4).reshape(
        B * G, H_, W_, Cg)
    g2 = loc.permute(0, 3, 1, 2, 4, 5).reshape(B * G, Ho * Wo, K, 2) \
        * 2.0 - 1.0
    sampled = grid_sample_2d(v, g2, align_corners=False)
    m = mask.reshape(B, Ho, Wo, G, K).permute(0, 3, 1, 2, 4).reshape(
        B * G, Ho * Wo, K)
    out = torch.einsum("nqkc,nqk->nqc", sampled, m.to(sampled.dtype))
    return out.reshape(B, G, Ho, Wo, Cg).permute(0, 2, 3, 1, 4).reshape(
        B, Ho, Wo, C)
