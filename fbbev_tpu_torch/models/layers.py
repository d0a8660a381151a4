"""Shared building blocks of the port.  Counterpart of
``fbbev_tpu/models/layers.py``, limited to what the serving and training
paths use.

2D blocks take NCHW tensors and 3D blocks ``(B, C, Y, X, Z)`` tensors
(``nn.Conv3d``'s ``(N, C, D, H, W)`` with D=Y, H=X, W=Z), so the JAX
package's ``(ky, kx, kz)`` kernels map onto PyTorch's without a flip.
Every convolution is built with explicit integer padding: flax's ``SAME``
pads a stride-2 convolution asymmetrically, which no PyTorch
convolution does, so the JAX package passes explicit paddings on the
paths ported here and so does the port.  Module and parameter names are
the reference's torch names, so the converted state dict loads with
``strict=True``.  The JAX package's TPU convolution routings (z-slab,
z-fold) are plain ``nn.Conv3d``/``nn.Conv2d`` here, except where they
reach a TPU kernel.  Its Pallas 3x3 conv (``FBBEV_PALLAS3X3=1``) is the
port's K7: convolutions built with ``pallas3x3=True`` take it, the 2D 3x3
stride-1 ones directly (:class:`Conv3x3K7`) and the 3x3x3 stride-1 ones
through the z-slab decomposition (:class:`Conv3dZSlabK7`).  Its Pallas
3x3x3 conv (``FBBEV_CONV3D=pallas``) is the port's K6: 3x3x3 stride-1
convolutions built with ``pallas_conv3d=True`` take it in eval
(:class:`Conv3dK6`).

BatchNorm has flax semantics (:func:`batch_norm`): in train mode it
normalises with the biased batch variance and updates the running
statistics with it, ``running = 0.9 * running + 0.1 * batch``, the batch
statistics taken in float32 (the running statistics are float32 in
training: the ``Trainer`` makes every BatchNorm float32).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fbbev_tpu_torch.ops import pallas_conv
from fbbev_tpu_torch.ops import pallas_conv3d as conv3d_k6


class Conv3x3K7(nn.Conv2d):
    """3x3 stride-1 padding-1 ``nn.Conv2d`` whose forward and input
    gradient run on K7 (``ops/pallas_conv.py``) wherever the JAX routing
    gate :func:`pallas_conv.supports` holds for the input, and on
    ``nn.Conv2d`` elsewhere, as ``layers.py:74-84`` of the JAX package
    routes."""

    def forward(self, x):
        if not pallas_conv.supports(x.shape, self.out_channels):
            return super().forward(x)
        y = pallas_conv.conv3x3(x, self.weight)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class Conv3dZSlabK7(nn.Conv3d):
    """3x3x3 stride-1 padding-1 ``nn.Conv3d`` on ``(B, C, Y, X, Z)``
    tensors as the JAX package's stride-1 z-slab decomposition
    (``Conv3DZSlab``, ``layers.py:136-183``): three z-shifted 3x3 2D convs
    over the ``(B*Z, C, Y, X)`` slabs, summed in the input's type, each on
    K7 (forward and input gradient) where :func:`pallas_conv.supports`
    holds for a slab, and ``nn.Conv3d`` elsewhere."""

    def forward(self, x):
        B, C, Y, X, Z = x.shape
        if not pallas_conv.supports((B * Z, C, Y, X), self.out_channels):
            return super().forward(x)
        # (B, Z+2, Y, X, C) contiguous: each slab is a free channels-last
        # view, the memory K7 reads
        xp = F.pad(x, (1, 1)).permute(0, 4, 2, 3, 1).contiguous()
        out = None
        for dz in range(3):
            xs = xp[:, dz:dz + Z].reshape(B * Z, Y, X, C).permute(0, 3, 1, 2)
            y = pallas_conv.conv3x3(xs, self.weight[..., dz])
            y = y.permute(0, 2, 3, 1).reshape(B, Z, Y, X, -1)
            out = y if out is None else out + y
        out = out.permute(0, 4, 2, 3, 1)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)[:, None, None, None]
        return out


class Conv3dK6(Conv3dZSlabK7):
    """3x3x3 stride-1 padding-1 ``nn.Conv3d`` on ``(B, C, Y, X, Z)``
    tensors that runs on K6 (``ops/pallas_conv3d.py``, no backward) in
    eval wherever the JAX routing gate ``_pallas3d_eligible``
    (``layers.py:60-71``: :func:`conv3d_k6.supports` on the channels-last
    shape) holds, as ``ConvBN`` routes to ``PallasConv3D`` there
    (``layers.py:333-336``).  Elsewhere, and always in train mode, it is
    a :class:`Conv3dZSlabK7` when ``zslab`` (``pallas3x3`` as well) and an
    ``nn.Conv3d`` otherwise.  K6 reads channels-last memory: free when x
    is in ``torch.channels_last_3d`` format, a copy otherwise."""

    def __init__(self, *args, zslab: bool = False, **kw):
        super().__init__(*args, **kw)
        self.zslab = zslab

    def forward(self, x):
        B, C, Y, X, Z = x.shape
        if not self.training and conv3d_k6.supports((B, Y, X, Z, C),
                                                    self.out_channels):
            y = conv3d_k6.conv3d_3x3x3(x, self.weight)
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)[:, None, None, None]
            return y
        if self.zslab:
            return super().forward(x)
        return nn.Conv3d.forward(self, x)


def conv(ndim: int, cin: int, cout: int, k: int, stride: int = 1,
         padding: int = 0, dilation: int = 1, bias: bool = False,
         pallas3x3: bool = False, pallas_conv3d: bool = False):
    """``nn.Conv{2,3}d`` with explicit integer padding.  A 3x3(x3)
    stride-1 padding-1 undilated conv is, with ``pallas_conv3d``, a
    :class:`Conv3dK6` (3D); else with ``pallas3x3`` a :class:`Conv3x3K7`
    (2D) or a :class:`Conv3dZSlabK7` (3D)."""
    assert isinstance(padding, int), padding
    if (k, stride, padding, dilation) == (3, 1, 1, 1):
        if pallas_conv3d and ndim == 3:
            return Conv3dK6(cin, cout, 3, padding=1, bias=bias,
                            zslab=pallas3x3)
        if pallas3x3:
            cls = Conv3x3K7 if ndim == 2 else Conv3dZSlabK7
            return cls(cin, cout, 3, padding=1, bias=bias)
    cls = nn.Conv2d if ndim == 2 else nn.Conv3d
    return cls(cin, cout, k, stride=stride, padding=padding,
               dilation=dilation, bias=bias)


def batch_norm(m: "BatchNorm", x: torch.Tensor, dim: int = 1
               ) -> torch.Tensor:
    """BatchNorm of ``m`` over channel axis ``dim`` of ``x``, flax
    semantics.  Eval: the running statistics.  Train: the batch statistics
    over every other axis, biased variance; unless ``m.update_stats`` is
    off (a checkpointed segment's recomputation), the running statistics
    move by ``0.9 * running + 0.1 * batch`` with that biased variance.

    ``F.batch_norm`` takes the statistics in one float32 pass and moves
    the running variance with the unbiased batch variance v_u = v * n /
    (n - 1); that update is corrected here to the biased one:
    ``0.9 r + 0.1 v = r' - (r' - 0.9 r) / n`` for its result r'.  Like
    ``nn.BatchNorm``, training needs more than one value per channel."""
    move = dim % x.ndim != 1
    if move:
        x = x.movedim(dim, 1)
    if not m.training:
        y = F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                         False, 0.0, m.eps)
    else:
        # copies: autograd keeps the tensors it was given unmodified, and a
        # checkpointed recomputation saves the same tensors as the forward
        mean, var = m.running_mean.clone(), m.running_var.clone()
        y = F.batch_norm(x, mean, var, m.weight, m.bias, True, m.momentum,
                         m.eps)
        if m.update_stats:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m.running_mean.copy_(mean)
                m.running_var.copy_(
                    var - (var - (1.0 - m.momentum) * m.running_var) / n)
    return y.movedim(1, dim) if move else y


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over axis 1 of an input of any rank, :func:`batch_norm`'s
    semantics; ``nn.BatchNorm{1,2,3}d``'s parameters and buffers."""

    update_stats = True  # off while a checkpointed stage recomputes

    def forward(self, x):
        return batch_norm(self, x, 1)


def bn(ndim: int, c: int):
    """BatchNorm of ``c`` channels (``ndim`` names the reference's
    ``BatchNorm{ndim}d``; the module takes any rank)."""
    return BatchNorm(c, eps=1e-5, momentum=0.1)


def checkpoint_stage(stage: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``stage(x)`` under activation checkpointing (the JAX config's
    ``remat=True``): the backward recomputes the stage, and its BatchNorms
    leave the running statistics alone on that second pass, as flax's
    ``nn.remat`` discards the recomputation's state updates."""
    norms = [m for m in stage.modules() if isinstance(m, BatchNorm)]
    calls = []

    def run(x):
        first = not calls
        calls.append(1)
        for m in norms:
            m.update_stats = first
        try:
            return stage(x)
        finally:
            for m in norms:
                m.update_stats = True

    # no random ops inside a stage: the RNG state need not be restored
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def conv_bn_relu(ndim: int, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = False,
                 relu: bool = True, pallas3x3: bool = False,
                 pallas_conv3d: bool = False) -> nn.Sequential:
    """``Sequential(conv, bn[, relu])`` -- the reference's ``X.0``/``X.1``
    naming."""
    mods = [conv(ndim, cin, cout, k, stride, padding, dilation, bias,
                 pallas3x3, pallas_conv3d), bn(ndim, cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class ConvModule(nn.Module):
    """mmcv ``ConvModule``: ``conv`` (+ ``bn``) (+ relu)."""

    def __init__(self, ndim: int, cin: int, cout: int, k: int,
                 padding: int = 0, bias: bool = False, norm: bool = True,
                 relu: bool = True, pallas3x3: bool = False,
                 pallas_conv3d: bool = False):
        super().__init__()
        self.conv = conv(ndim, cin, cout, k, padding=padding, bias=bias,
                         pallas3x3=pallas3x3, pallas_conv3d=pallas_conv3d)
        self.bn = bn(ndim, cout) if norm else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    """ResNet basic block (two 3x3 convs + identity), 2D or 3D; the 3D
    encoder's convs carry a bias, the 2D ones do not."""

    def __init__(self, cin: int, cout: int, stride: int = 1, ndim: int = 2,
                 bias: bool = False, pallas3x3: bool = False,
                 pallas_conv3d: bool = False):
        super().__init__()
        self.conv1 = conv(ndim, cin, cout, 3, stride, 1, bias=bias,
                          pallas3x3=pallas3x3, pallas_conv3d=pallas_conv3d)
        self.bn1 = bn(ndim, cout)
        self.conv2 = conv(ndim, cout, cout, 3, 1, 1, bias=bias,
                          pallas3x3=pallas3x3, pallas_conv3d=pallas_conv3d)
        self.bn2 = bn(ndim, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = conv_bn_relu(ndim, cin, cout, 1, stride, 0,
                                           bias=bias, relu=False)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class Bottleneck(nn.Module):
    """Torch-style ResNet bottleneck, stride on the 3x3 conv."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 pallas3x3: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv(2, cin, planes, 1)
        self.bn1 = bn(2, planes)
        self.conv2 = conv(2, planes, planes, 3, stride, 1,
                          pallas3x3=pallas3x3)
        self.bn2 = bn(2, planes)
        self.conv3 = conv(2, planes, out, 1)
        self.bn3 = bn(2, out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = conv_bn_relu(2, cin, out, 1, stride, 0,
                                           relu=False)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class Mlp(nn.Module):
    """fc1 -> relu -> fc2."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    """Camera-parameter squeeze-excitation gate with the reference's 1x1
    convs: ``x * sigmoid(expand(relu(reduce(x_se))))``."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, channels, 1, bias=True)
        self.conv_expand = nn.Conv2d(channels, channels, 1, bias=True)

    def forward(self, x, x_se):
        """x (B, C, H, W); x_se (B, C)."""
        se = F.linear(x_se, self.conv_reduce.weight[:, :, 0, 0],
                      self.conv_reduce.bias)
        se = F.linear(F.relu(se), self.conv_expand.weight[:, :, 0, 0],
                      self.conv_expand.bias)
        return x * torch.sigmoid(se).to(x.dtype)[:, :, None, None]


def max_pool_same(x, window: int, strides: int):
    """Torch-style max pool with symmetric ``(window-1)//2`` padding."""
    return F.max_pool2d(x, window, strides, (window - 1) // 2)


def upsample_nearest(x, out_hw: Tuple[int, int]):
    """Nearest resize of NCHW ``x``.  ``jax.image.resize('nearest')``
    samples half-pixel centres, which is PyTorch's ``nearest-exact``
    (plain ``nearest`` floors ``i*in/out`` and differs at non-integer
    ratios)."""
    return F.interpolate(x, size=tuple(out_hw), mode="nearest-exact")


def upsample_int_axis(x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """Exact integer-factor linear upsample along one axis
    (align_corners=False, half-pixel centres, edge clamp): phase k of the
    output samples input coordinate (k + .5)/s - .5, a fixed 2-tap lerp,
    each product and the sum in x's type.  Each weight is first rounded
    to x's type, as JAX rounds a Python float to a bf16 operand's type
    (PyTorch would keep it in float32).  The port's copy of
    ``fbbev_tpu/models/layers.py:519``."""
    if s == 1:
        return x
    n = x.shape[axis]
    i = torch.arange(n, device=x.device)
    prev = x.index_select(axis, (i - 1).clamp(min=0))
    nxt = x.index_select(axis, (i + 1).clamp(max=n - 1))

    def rnd(w: float) -> float:
        return float(torch.tensor(w, dtype=x.dtype))

    phases = []
    for k in range(s):
        c = (k + 0.5) / s - 0.5
        if c < 0:
            w = c + 1.0  # lerp(prev, x, w)
            phases.append(rnd(1.0 - w) * prev + rnd(w) * x)
        else:
            w = c  # lerp(x, next, w)
            phases.append(rnd(1.0 - w) * x + rnd(w) * nxt)
    shape = list(x.shape)
    shape[axis] *= s
    return torch.stack(phases, dim=axis + 1).reshape(shape)


def resize_trilinear(x, out_size: Sequence[int]):
    """Trilinear resize of ``(B, C, D, H, W)`` with half-pixel centres and
    edge clamp (align_corners=False), the JAX package's
    ``resize_trilinear`` for upsampling."""
    return F.interpolate(x, size=tuple(out_size), mode="trilinear",
                         align_corners=False)


class TimeEmbedConvBN(nn.Sequential):
    """SoloFusion time-embedding conv ``Sequential(Conv3d(C+1, F, 1),
    BN, ReLU)`` applied to ``concat([x, e])`` without the concat:
    ``x @ k[:C] + e * k[C] + bias``.  Channels-last ``(..., C)`` input."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv3d(cin + 1, cout, 1, bias=True),
                         bn(3, cout), nn.ReLU())

    def kernel(self) -> torch.Tensor:
        """(C+1, F) matrix of the 1x1x1 conv."""
        return self[0].weight[:, :, 0, 0, 0].t()

    def forward(self, x, e):
        k = self.kernel()
        y = x @ k[:-1] + e.to(x.dtype) * k[-1] + self[0].bias
        return F.relu(channels_last_bn(self[1], y))


class RingCatConvBN(nn.Sequential):
    """SoloFusion cat conv ``Sequential(Conv3d(Cin, F, 1), BN, ReLU)``
    over ``[slots | curr]`` given as a slots contribution computed
    elsewhere (the K1 epilogue) plus ``x2 @ k[perm2]``."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv3d(cin, cout, 1, bias=True), bn(3, cout),
                         nn.ReLU())

    def kernel(self) -> torch.Tensor:
        """(Cin, F) matrix of the 1x1x1 conv."""
        return self[0].weight[:, :, 0, 0, 0].t()

    def forward(self, part, x2, perm2):
        """part (B, ..., F) slots contribution; x2 (B, ..., C2);
        perm2 (B, C2) weight rows of x2's channels."""
        k = self.kernel()
        y = (part.to(x2.dtype)
             + torch.einsum("b...c,bco->b...o", x2, k[perm2])
             + self[0].bias)
        return F.relu(channels_last_bn(self[1], y))

    def aged(self, frames):
        """The plain cat conv over age-ordered channels-last frames
        ``(B, ..., Cin)`` (newest first): the JAX package's
        ``history_keyframe_cat_conv`` without ``perm``."""
        y = frames @ self.kernel() + self[0].bias
        return F.relu(channels_last_bn(self[1], y))


def channels_last_bn(m: BatchNorm, x):
    """:func:`batch_norm` over the last axis of a channels-last tensor."""
    return batch_norm(m, x, -1)
