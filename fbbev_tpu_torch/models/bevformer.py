"""Backward projection: depth-aware BEVFormer-style BEV refinement.
Counterpart of ``fbbev_tpu/models/bevformer.py``.

In eval both attentions sample through K3 (``ops/pallas_sample.py``): the
spatial cross-attention over each camera's feature map, and the BEV
self-attention with the BEV itself as the single-level value map.  In
training they sample through the differentiable gather form
(``ops/deform_attn.py::deformable_sample_attend``), as the JAX package
keeps its Pallas sampling out of training (``bevformer.py:67-82``).  The
cross-attention uses the static-K rebatch of the JAX package: per (sample,
camera) the visible queries are compacted to the front (stable) and padded
to ``max_queries_per_cam``; the per-camera results are gathered back with
``index_add_``.  All of it depends only on the rig, so serving computes it
once (:meth:`BackwardProjection.static_terms`, with the dense
depth-sampling matrix); training computes it from each batch's cameras and
samples the predicted depth at the anchors with bilinear gathers.

The dtype flow is flax's (``fbbev_tpu/models/bevformer.py``): the BEV
query embedding, the positional embeddings and the LayerNorms are float32
in a bf16 model (:meth:`BackwardProjection.float32_islands`,
``layers.LayerNorm``), so the query stream is float32 from the seeded query
on; each Linear casts its input to the model's type and adds its bias
after the product (``layers.Linear``, flax's ``nn.Dense``), and its bf16
output joins the stream in the residual sums, which are float32.  The
sampled values are float32 (K3's result), cast back at the output
projections.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fbbev_tpu_torch import geometry, parallel
from fbbev_tpu_torch.ops import deform_attn, pallas_sample
from fbbev_tpu_torch.models.layers import LayerNorm, Linear, softmax
from fbbev_tpu_torch.ops.deform_attn import bilinear_sample_matrix


def msda_offset_bias(num_heads: int, num_levels: int, num_points: int,
                     num_z_anchors: int = 1) -> np.ndarray:
    """mmcv's directional sampling-offset bias init: head h points along
    angle 2*pi*h/heads, scaled by (i+1) over the per-anchor point index."""
    thetas = np.arange(num_heads, dtype=np.float32) * (
        2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    each = num_points // num_z_anchors
    grid = np.tile(grid[:, None, None, None, :],
                   (1, num_levels, each, num_z_anchors, 1))
    for i in range(each):
        grid[:, :, i, :, :] *= i + 1
    return grid.reshape(-1)


def _msda_linears(m: nn.Module, C: int, heads: int, L: int, P: int,
                  Z: int = 1):
    m.sampling_offsets = Linear(C, heads * L * P * 2)
    m.attention_weights = Linear(C, heads * L * P)
    m.value_proj = Linear(C, C)
    with torch.no_grad():
        m.sampling_offsets.weight.zero_()
        m.sampling_offsets.bias.copy_(torch.from_numpy(
            msda_offset_bias(heads, L, P, Z)))
        m.attention_weights.weight.zero_()
        m.attention_weights.bias.zero_()


class LearnedPositionalEncoding(nn.Module):
    """Learned row + col BEV positional map, channels [col(x) ; row(y)]."""

    def __init__(self, num_feats: int, h: int, w: int):
        super().__init__()
        self.row_embed = nn.Embedding(h, num_feats)
        self.col_embed = nn.Embedding(w, num_feats)

    def forward(self, batch: int) -> torch.Tensor:
        col, row = self.col_embed.weight, self.row_embed.weight
        h, w = row.shape[0], col.shape[0]
        pos = torch.cat([col[None].expand(h, w, -1),
                         row[:, None].expand(h, w, -1)], -1)
        return pos.reshape(1, h * w, -1).expand(batch, -1, -1)


class DeformableSelfAttention(nn.Module):
    """BEV-plane single-level deformable self-attention (mmcv
    ``MultiScaleDeformableAttention``, dropout 0)."""

    def __init__(self, embed_dims: int = 80, num_heads: int = 8,
                 num_points: int = 4):
        super().__init__()
        self.heads, self.P = num_heads, num_points
        _msda_linears(self, embed_dims, num_heads, 1, num_points)
        self.output_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, query_pos, ref_2d, spatial_shape):
        B, Q, C = query.shape
        H, W = spatial_shape
        q = query + query_pos
        v = self.value_proj(query).reshape(B, Q, self.heads, -1)
        off = self.sampling_offsets(q).reshape(B, Q, self.heads, self.P, 2)
        attn = softmax(self.attention_weights(q).reshape(
            B, Q, self.heads, self.P), -1)
        norm = torch.tensor([W, H], dtype=torch.float32,
                            device=query.device)
        loc = ref_2d[:, :, None, None, :] + off / norm
        out = _attend(self, selfattn=True)(v, (H, W), loc, attn)
        return self.output_proj(out) + query


def _attend(m: nn.Module, selfattn: bool = False):
    """The deformable sampling of module ``m``: K3 in eval (``selfattn``
    picks its launch counter), the differentiable gather form in
    training."""
    if m.training:
        return deform_attn.deformable_sample_attend
    return functools.partial(pallas_sample.deformable_sample_attend,
                             selfattn=selfattn)


class DepthAwareDeformableAttention(nn.Module):
    """Inner deformable attention of the spatial cross-attention, with the
    predicted depth distribution modulating the attention weights."""

    def __init__(self, embed_dims: int = 80, num_heads: int = 8,
                 num_points: int = 8, num_z_anchors: int = 4):
        super().__init__()
        self.heads, self.P, self.Z = num_heads, num_points, num_z_anchors
        _msda_linears(self, embed_dims, num_heads, 1, num_points,
                      num_z_anchors)

    def forward(self, query, value, ref_points, spatial_shape, depth_onehot,
                pred_depth, depth_sample_mat=None):
        """query (B', K, C); value (B', H*W, C); ref_points (B', K, Z, 2);
        depth_onehot (B', K, Z, DC); pred_depth (B', H*W, DC);
        depth_sample_mat (B', K*Z, H*W) rig-static bilinear matrix, or
        None to sample ``pred_depth`` at the anchors by gathers."""
        Bp, K, C = query.shape
        H, W = spatial_shape
        heads, P, Z = self.heads, self.P, self.Z
        each = P // Z
        v = self.value_proj(value).reshape(Bp, -1, heads, C // heads)
        off = self.sampling_offsets(query).reshape(Bp, K, heads, each, Z, 2)
        attn = softmax(self.attention_weights(query).reshape(
            Bp, K, heads, P), -1)
        norm = torch.tensor([W, H], dtype=torch.float32,
                            device=query.device)
        loc = (ref_points[:, :, None, None, :, :] + off / norm).reshape(
            Bp, K, heads, P, 2)
        DC = pred_depth.shape[-1]
        if depth_sample_mat is None:
            # bilinear taps: one head, one point, unit weight
            depth_at_ref = deform_attn.deformable_sample_attend(
                pred_depth.float()[:, :, None], (H, W),
                ref_points.reshape(Bp, K * Z, 1, 1, 2),
                torch.ones(Bp, K * Z, 1, 1, device=query.device)).reshape(
                    Bp, K, Z, DC)
        else:
            depth_at_ref = torch.bmm(depth_sample_mat,
                                     pred_depth.float()).reshape(
                                         Bp, K, Z, DC)
        depth_w = (depth_at_ref * depth_onehot).sum(-1)        # (B', K, Z)
        depth_w = depth_w[:, :, None, :].expand(Bp, K, each, Z).reshape(
            Bp, K, P)
        return _attend(self)(v, (H, W), loc, attn * depth_w[:, :, None, :])


def spatial_ca_static_terms(ref_cam, per_cam_mask, query_depth, dbound,
                            num_depth_bins: int,
                            max_queries_per_cam: Optional[int],
                            feat_hw: Optional[Tuple[int, int]] = None
                            ) -> Dict[str, torch.Tensor]:
    """Rig-static tensors of the spatial cross-attention.

    ref_cam (B, N, Q, Z, 2); per_cam_mask / query_depth (B, N, Q, Z).
    Returns query_valid (B, N, Q), count (B, Q), the rebatch idx (B, N, K),
    sel_valid, ref_k (B, N, K, Z, 2), oh_k (B, N, K, Z, DC) and, when
    ``feat_hw`` is given, the depth sampling matrix dsmat (B, N, K*Z,
    Hf*Wf).  ``K >= Q`` (or None) keeps every query, which is the dense
    formulation."""
    B, N, Q, Z, _ = ref_cam.shape
    lo, _hi, step = dbound
    valid = per_cam_mask.any(-1)
    # the cameras of every 'space' rank of an active mesh count
    count = parallel.all_reduce_sum(valid.float().sum(1),
                                    "space").clamp(min=1.0)
    K = Q if max_queries_per_cam is None else min(max_queries_per_cam, Q)
    idx = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)[
        ..., :K]
    qd = torch.gather(query_depth, 2, idx[..., None].expand(B, N, K, Z))
    dbin = torch.clamp(torch.floor((qd - lo) / step), 0, num_depth_bins - 1)
    ref_k = torch.gather(ref_cam, 2,
                         idx[..., None, None].expand(B, N, K, Z, 2))
    terms = dict(
        query_valid=valid, count=count, idx=idx,
        sel_valid=torch.gather(valid, 2, idx),
        ref_k=ref_k,
        oh_k=F.one_hot(dbin.long(), num_depth_bins).float())
    if feat_hw is not None:
        terms["dsmat"] = bilinear_sample_matrix(
            ref_k.reshape(B, N, K * Z, 2), feat_hw)
    return terms


class DepthAwareSpatialCrossAttention(nn.Module):
    """Per-camera BEV -> image cross-attention over the rebatched visible
    queries, averaged over the cameras that see each query."""

    def __init__(self, embed_dims: int = 80, num_points: int = 8,
                 num_z_anchors: int = 4):
        super().__init__()
        self.deformable_attention = DepthAwareDeformableAttention(
            embed_dims, 8, num_points, num_z_anchors)
        self.output_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, query_pos, cam_feats, pred_depth, t):
        """query (B, Q, C); cam_feats (B, N, Hf, Wf, C); pred_depth
        (B, N, DC, Hf, Wf); t: :func:`spatial_ca_static_terms`."""
        B, Q, C = query.shape
        N, Hf, Wf = cam_feats.shape[1:4]
        DC = pred_depth.shape[2]
        idx = t["idx"]
        K, Z = idx.shape[-1], t["ref_k"].shape[3]
        q = query + query_pos
        value = cam_feats.reshape(B * N, Hf * Wf, C)
        pd = pred_depth.reshape(B * N, DC, Hf * Wf).transpose(1, 2)
        qd = torch.gather(q[:, None].expand(B, N, Q, C), 2,
                          idx[..., None].expand(B, N, K, C))
        out = self.deformable_attention(
            qd.reshape(B * N, K, C), value,
            t["ref_k"].reshape(B * N, K, Z, 2), (Hf, Wf),
            t["oh_k"].reshape(B * N, K, Z, DC), pd,
            t["dsmat"].reshape(B * N, K * Z, Hf * Wf) if "dsmat" in t
            else None)
        out = out.reshape(B, N, K, C) * t["sel_valid"][..., None]
        seg = (torch.arange(B, device=idx.device)[:, None, None] * Q
               + idx).reshape(-1)
        slots = torch.zeros(B * Q, C, dtype=out.dtype, device=out.device)
        slots.index_add_(0, seg, out.reshape(B * N * K, C))
        # under a mesh, the other 'space' ranks' cameras add in
        slots = parallel.all_reduce_sum(slots, "space")
        slots = slots.reshape(B, Q, C) / t["count"][..., None]
        return self.output_proj(slots) + query


class FFN(nn.Module):
    def __init__(self, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(embed_dims, feedforward_channels),
                          nn.ReLU()),
            Linear(feedforward_channels, embed_dims))

    def forward(self, x):
        return self.layers(x) + x


class BEVFormerEncoderLayer(nn.Module):
    """self_attn -> norm -> cross_attn -> norm -> ffn -> norm."""

    def __init__(self, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.attentions = nn.ModuleList([
            DeformableSelfAttention(embed_dims),
            DepthAwareSpatialCrossAttention(embed_dims)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])
        self.norms = nn.ModuleList(
            LayerNorm(embed_dims, eps=1e-5) for _ in range(3))

    def forward(self, query, bev_pos, ref_2d, bev_hw, cam_feats, pred_depth,
                terms):
        query = self.norms[0](self.attentions[0](query, bev_pos, ref_2d,
                                                 bev_hw))
        query = self.norms[1](self.attentions[1](query, bev_pos, cam_feats,
                                                 pred_depth, terms))
        return self.norms[2](self.ffns[0](query))


class BackwardProjection(nn.Module):
    """BEV-query refinement head (one encoder layer)."""

    def __init__(self, bev_h: int, bev_w: int, embed_dims: int,
                 feedforward_channels: int, pos_num_feats: int,
                 grid_config: Optional[dict], input_size: Tuple[int, int],
                 dbound: Sequence[float],
                 max_queries_per_cam: Optional[int] = None,
                 pc_range: Sequence[float] = (-40, -40, -1.0, 40, 40, 5.4)):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.pc_range = tuple(pc_range)
        # without a grid, the anchors span pc_range (JAX ``_grid_cfg``)
        r = self.pc_range
        self.grid_config = grid_config or {
            "x": (r[0], r[3], (r[3] - r[0]) / bev_w),
            "y": (r[1], r[4], (r[4] - r[1]) / bev_h),
            "z": (r[2], r[5], 1.6)}
        self.input_size = tuple(input_size)
        self.dbound = tuple(dbound)
        self.max_queries_per_cam = max_queries_per_cam
        self.bev_embedding = nn.Embedding(bev_h * bev_w, embed_dims)
        self.positional_encoding = LearnedPositionalEncoding(
            pos_num_feats, bev_h, bev_w)
        self.transformer = nn.Module()
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layers = nn.ModuleList(
            [BEVFormerEncoderLayer(embed_dims, feedforward_channels)])

    def float32_islands(self):
        """The query and positional embeddings, float32 in a bf16 model as
        JAX's ``self.param`` / ``nn.Embed`` without a dtype (the
        LayerNorms declare themselves)."""
        return [self.bev_embedding, self.positional_encoding]

    def static_terms(self, cam: geometry.CamParams, num_depth_bins: int,
                     feat_hw: Optional[Tuple[int, int]] = None
                     ) -> Dict[str, torch.Tensor]:
        """Every rig-static tensor of this head for a calibrated rig; the
        dense depth-sampling matrix only with ``feat_hw``."""
        H, W, gc = self.bev_h, self.bev_w, self.grid_config
        ref3d = geometry.bev_reference_points_3d(
            tuple(gc["x"]), tuple(gc["y"]), tuple(gc["z"]))
        assert ref3d.shape[:2] == (H, W), (ref3d.shape, H, W)
        Z = ref3d.shape[2]
        uv, mask, depth = geometry.ego_to_cam_pixels(
            torch.from_numpy(ref3d.reshape(-1, 3)).to(cam.trans.device),
            cam, self.input_size)
        B, N = uv.shape[:2]
        return spatial_ca_static_terms(
            uv.reshape(B, N, H * W, Z, 2), mask.reshape(B, N, H * W, Z),
            depth.reshape(B, N, H * W, Z), self.dbound, num_depth_bins,
            self.max_queries_per_cam, feat_hw)

    def forward(self, cam_feats, lss_bev, pred_depth, terms=None, cam=None):
        """cam_feats (B, N, Hf, Wf, C); lss_bev (B, H, W, C); pred_depth
        (B, N, DC, Hf, Wf) -> refined (B, H, W, C) float32 (the query
        stream, whatever the model's type).  ``terms``: the
        serving hoist (:meth:`static_terms`); without it they are computed
        from ``cam``, without the depth-sampling matrix."""
        if terms is None:
            terms = self.static_terms(cam, pred_depth.shape[2])
        B = cam_feats.shape[0]
        H, W = self.bev_h, self.bev_w
        C = lss_bev.shape[-1]
        query = self.bev_embedding.weight[None] + lss_bev.reshape(B, H * W, C)
        bev_pos = self.positional_encoding(B)
        ref_2d = torch.from_numpy(geometry.bev_reference_points_2d(H, W)).to(
            query.device)[None].expand(B, -1, -1)
        for layer in self.transformer.encoder.layers:
            query = layer(query, bev_pos, ref_2d, (H, W), cam_feats,
                          pred_depth, terms)
        return query.reshape(B, H, W, C)
