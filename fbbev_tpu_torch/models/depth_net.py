"""Camera-aware depth network.  Counterpart of
``fbbev_tpu/models/depth_net.py`` (``CM_DepthNet``, ``ASPP``,
``get_mlp_input``, ``depth_loss``).  The camera vector's BatchNorm, MLPs
and SE gates stay float32 whatever the model dtype, as in the JAX package
(in training that BatchNorm takes its batch statistics over the cameras
in float32); the depth softmax is taken in float32.  The dtype flow is
JAX's: the SE products are float32 (a bf16 map times a float32 gate), so
in a bf16 model the depth branch's basic blocks carry a float32 residual
stream; the convs cast their input to the model's type
(``layers.FlaxConv``).  ``pallas3x3`` routes the reduce conv and the basic
blocks' 3x3 convs to K7."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fbbev_tpu_torch.models.layers import (
    BasicBlock, Conv2d, Mlp, SELayer, bn, conv, conv_bn_relu)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (dilations 1/6/12/18 + global pool);
    the reference's dropout is omitted (eval)."""

    def __init__(self, cin: int, mid: int):
        super().__init__()
        self.aspp1 = _Atrous(cin, mid, 1, 0, 1)
        self.aspp2 = _Atrous(cin, mid, 3, 6, 6)
        self.aspp3 = _Atrous(cin, mid, 3, 12, 12)
        self.aspp4 = _Atrous(cin, mid, 3, 18, 18)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), conv(2, cin, mid, 1), bn(2, mid),
            nn.ReLU())
        self.conv1 = conv(2, 5 * mid, mid, 1)
        self.bn1 = bn(2, mid)

    def forward(self, x):
        b = [self.aspp1(x), self.aspp2(x), self.aspp3(x), self.aspp4(x)]
        gp = self.global_avg_pool(x).expand_as(b[3])
        y = torch.cat(b + [gp], dim=1)
        return F.relu(self.bn1(self.conv1(y)))


class _Atrous(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, padding: int,
                 dilation: int):
        super().__init__()
        self.atrous_conv = conv(2, cin, cout, k, 1, padding, dilation)
        self.bn = bn(2, cout)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class CM_DepthNet(nn.Module):
    def __init__(self, in_channels: int = 256, mid_channels: int = 512,
                 context_channels: int = 80, depth_channels: int = 80,
                 pallas3x3: bool = False):
        super().__init__()
        m = mid_channels
        self.context_channels = context_channels
        self.depth_channels = depth_channels
        self.bn = bn(1, 27)
        self.reduce_conv = conv_bn_relu(2, in_channels, m, 3, 1, 1,
                                        pallas3x3=pallas3x3)
        self.context_mlp = Mlp(27, m, m)
        self.context_se = SELayer(m)
        self.context_conv = Conv2d(m, context_channels, 1, bias=True)
        self.depth_mlp = Mlp(27, m, m)
        self.depth_se = SELayer(m)
        self.depth_conv = nn.Sequential(
            *(BasicBlock(m, m, pallas3x3=pallas3x3) for _ in range(3)),
            ASPP(m, m), Conv2d(m, depth_channels, 1, bias=True))

    def float32_islands(self):
        """Submodules kept in float32 under a bf16 model (the camera
        vector's BatchNorm declares itself)."""
        return [self.context_mlp, self.depth_mlp, self.context_se,
                self.depth_se]

    def forward(self, x, mlp_input):
        """x (B, N, H, W, C) image features; mlp_input (B, N, 27).

        Returns context (B, N, H, W, Cctx) and the depth softmax
        (B, N, D, H, W) float32."""
        B, N, H, W, C = x.shape
        x = x.reshape(B * N, H, W, C).permute(0, 3, 1, 2)
        cam = self.bn(mlp_input.reshape(B * N, -1).float())
        x = self.reduce_conv(x)
        ctx = self.context_se(x, self.context_mlp(cam))
        ctx = self.context_conv(ctx)
        d = self.depth_se(x, self.depth_mlp(cam))
        d = self.depth_conv(d)
        depth = torch.softmax(d.float(), dim=1)
        ctx = ctx.permute(0, 2, 3, 1).reshape(B, N, H, W, -1)
        return ctx, depth.reshape(B, N, self.depth_channels, H, W)


def get_mlp_input(cam) -> torch.Tensor:
    """27-dim camera vector per (sample, camera): [fx, fy, cx, cy,
    post_rot(00, 01), post_tran_x, post_rot(10, 11), post_tran_y,
    bda(00, 01, 10, 11, 22), sensor2ego (3x4 row-major)]."""
    B, N = cam.trans.shape[:2]
    bda = cam.bda[:, None].expand(B, N, 3, 3)
    head = torch.stack([
        cam.intrins[..., 0, 0], cam.intrins[..., 1, 1],
        cam.intrins[..., 0, 2], cam.intrins[..., 1, 2],
        cam.post_rots[..., 0, 0], cam.post_rots[..., 0, 1],
        cam.post_trans[..., 0],
        cam.post_rots[..., 1, 0], cam.post_rots[..., 1, 1],
        cam.post_trans[..., 1],
        bda[..., 0, 0], bda[..., 0, 1], bda[..., 1, 0], bda[..., 1, 1],
        bda[..., 2, 2]], dim=-1)
    s2e = torch.cat([cam.rots, cam.trans[..., None]], -1).reshape(B, N, 12)
    return torch.cat([head, s2e], dim=-1)


def downsample_gt_depth(gt_depth: torch.Tensor, downsample: int,
                        depth_bounds: Sequence[float],
                        depth_channels: int) -> torch.Tensor:
    """Min-pool the GT depth to the feature resolution and one-hot its bin:
    ``(B*N*h*w, depth_channels)``, all-zero rows for background.
    Counterpart of ``depth_net.py:179`` (zeros count as +inf for the min;
    bin = (d - (lo - step)) / step, out of range -> dropped bin 0)."""
    B, N, H, W = gt_depth.shape
    ds = downsample
    g = gt_depth.reshape(B * N, H // ds, ds, W // ds, ds)
    g = g.permute(0, 1, 3, 2, 4).reshape(-1, ds * ds)
    g = torch.where(g == 0.0, torch.full_like(g, 1e5), g).min(-1).values
    lo, _hi, step = depth_bounds
    g = (g - (lo - step)) / step
    g = torch.where((g < depth_channels + 1) & (g >= 0.0), g,
                    torch.zeros_like(g))
    return F.one_hot(g.to(torch.int32).long(),
                     depth_channels + 1)[:, 1:].float()


def depth_loss(gt_depth: torch.Tensor, depth_pred: torch.Tensor,
               downsample: int, depth_bounds: Sequence[float],
               loss_weight: float = 1.0, count_sum=None) -> torch.Tensor:
    """Binary cross entropy of the predicted depth distribution ``(B, N,
    D, h, w)`` against the one-hot GT over foreground pixels, float32.
    Counterpart of ``depth_net.py:202``.  ``count_sum`` (under a mesh:
    the sum over every rank) turns the foreground count into the one
    the mean divides by, making the result this rank's share."""
    D = depth_pred.shape[2]
    labels = downsample_gt_depth(gt_depth, downsample, depth_bounds, D)
    preds = depth_pred.permute(0, 1, 3, 4, 2).reshape(-1, D).float()
    fg = labels.max(1).values > 0.0
    p = preds.clamp(1e-7, 1.0 - 1e-7)
    bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    bce = (bce * fg[:, None]).sum()
    count = fg.sum().float()
    if count_sum is not None:
        count = count_sum(count.detach().clone())
    return loss_weight * bce / torch.clamp(count, min=1.0)
