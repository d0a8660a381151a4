"""Deformable-attention helpers without a kernel.

Counterpart of ``fbbev_tpu/ops/deform_attn.py``: the mmcv PyTorch
formulation of multi-scale deformable attention (``F.grid_sample``,
align_corners=False, zero padding), the dense bilinear interpolation
matrix of rig-static sampling locations that serving hoists out of the
per-frame step, and the differentiable gather form of deformable
sampling (:func:`deformable_sample_attend`): K3's plain version, and what
training samples with (K3 records no backward).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def bilinear_corners(loc: torch.Tensor, H: int, W: int):
    """The four ``grid_sample`` (align_corners=False) corners of locations
    ``loc (..., 2)`` in [0, 1]: (flat index, weight) pairs, the index
    clamped into the map and the weight zero for corners outside it."""
    x = loc[..., 0] * W - 0.5
    y = loc[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        w = (1.0 - torch.abs(x - xi)) * (1.0 - torch.abs(y - yi))
        ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        yield idx, torch.where(ok, w, torch.zeros_like(w))


def bilinear_sample_matrix(loc: torch.Tensor,
                           spatial_shape: Tuple[int, int],
                           dtype=torch.float32) -> torch.Tensor:
    """Dense ``(..., S, H*W)`` bilinear interpolation matrix of static
    locations ``loc (..., S, 2)`` in [0, 1] (align_corners=False, zero
    padding), so that ``sample = mat @ value``."""
    H, W = spatial_shape
    mat = torch.zeros(loc.shape[:-1] + (H * W,), dtype=dtype,
                      device=loc.device)
    for idx, w in bilinear_corners(loc, H, W):
        mat.scatter_add_(-1, idx[..., None], w[..., None].to(dtype))
    return mat


def deformable_sample_attend(value: torch.Tensor,
                             spatial_shape: Tuple[int, int],
                             loc: torch.Tensor,
                             attn: torch.Tensor) -> torch.Tensor:
    """Single-level deformable sampling + attention sum, differentiable;
    counterpart of ``deform_attn.py:122`` and K3's plain version.  value
    (B, H*W, heads, hd); loc (B, Q, heads, P, 2) in [0, 1]; attn (B, Q,
    heads, P) -> (B, Q, heads*hd) f32.

    Zero-padded bilinear taps (``grid_sample`` align_corners=False), the
    exact taps everywhere (the JAX self-attention's grid-tiled form agrees
    inside its locality contract).  The weight tent_x * tent_y * attn is
    rounded to the value type, as the TPU kernel rounds its one-hot
    (``pallas_sample.py:65``); the sum is f32."""
    B, HW, heads, hd = value.shape
    H, W = spatial_shape
    Q, P = loc.shape[1], loc.shape[3]
    vh = value.permute(0, 2, 1, 3)                     # (B, heads, HW, hd)
    out = torch.zeros(B, heads, Q, hd, dtype=torch.float32,
                      device=value.device)
    for idx, w in bilinear_corners(loc.float(), H, W):
        w = (w * attn.float()).to(value.dtype).float()
        idx = idx.permute(0, 2, 1, 3).reshape(B, heads, Q * P, 1)
        g = torch.gather(vh, 2, idx.expand(-1, -1, -1, hd)).float()
        g = g.reshape(B, heads, Q, P, hd)
        out = out + (w.permute(0, 2, 1, 3)[..., None] * g).sum(3)
    return out.permute(0, 2, 1, 3).reshape(B, Q, heads * hd)


def multi_scale_deformable_attention(
        value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        sampling_locations: torch.Tensor,
        attention_weights: torch.Tensor) -> torch.Tensor:
    """mmcv ``multi_scale_deformable_attn_pytorch``: value (B, sum HW,
    heads, hd); locations (B, Q, heads, L, P, 2) in [0, 1]; weights (B, Q,
    heads, L, P) -> (B, Q, heads*hd)."""
    B, _, heads, hd = value.shape
    Q, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    out = torch.zeros(B * heads, hd, Q, dtype=value.dtype,
                      device=value.device)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W]
        start += H * W
        v = v.permute(0, 2, 3, 1).reshape(B * heads, hd, H, W)
        g = 2.0 * sampling_locations[:, :, :, lvl] - 1.0  # (B,Q,heads,P,2)
        g = g.permute(0, 2, 1, 3, 4).reshape(B * heads, Q, P, 2)
        s = F.grid_sample(v, g.to(v.dtype), mode="bilinear",
                          padding_mode="zeros", align_corners=False)
        a = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(
            B * heads, 1, Q, P)
        out = out + (s * a.to(s.dtype)).sum(-1)
    return out.reshape(B, heads * hd, Q).permute(0, 2, 1)
