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
statistics taken in float32.  Its parameters and running statistics
stay float32 in a bf16 model (a float32 island, :func:`cast_with_islands`)
and a bf16 input is normalised in float32, as flax's BatchNorm does.

Below float32 the layers round where flax's do (:class:`FlaxConv`,
:class:`Linear`, :func:`softmax`, :func:`resize_trilinear`); in float32
and wider they run PyTorch's fused kernels, within float32 rounding.

The BEV row split.  ``FBOCC`` marks the modules of its BEV stages
(``row_split``: the 3D convs, BatchNorms, FPN3D and the occ head; the
image stage, which shares :class:`BasicBlock` and :func:`conv`, stays
unmarked).  Under an active mesh whose ``space`` axis has more than one
rank a marked module's input holds this rank's rows of the BEV Y axis
(``parallel.split_rows``): a 3x3x3 conv fetches one halo row from each
neighbour (:class:`Conv3d`), an upsample along Y works on its rows with
one clamped halo row each side (:func:`resize_trilinear`), and a
BatchNorm takes the statistics of the world.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fbbev_tpu_torch import parallel
from fbbev_tpu_torch.ops import pallas_conv
from fbbev_tpu_torch.ops import pallas_conv3d as conv3d_k6


class FlaxConv:
    """Conv mixin with the dtype semantics of flax's ``nn.Conv`` built with
    a ``dtype``: the input is cast to the weight's type (a float32 input
    reaches a bf16 model's conv where JAX's dtype flow makes one, as in
    the depth net's residual stream), and below float32 the bias is added
    to the conv's result in the result's type, a second rounding
    (:func:`bias_after`).  An int8 conv (``utils/quantize.py``) replaces
    ``forward`` and quantizes the input uncast, as JAX's does."""

    def _conv_forward(self, x, weight, bias):
        if not bias_after(weight):
            return super()._conv_forward(x.to(weight.dtype), weight, bias)
        return add_bias(super()._conv_forward(x.to(weight.dtype), weight,
                                              None), bias)


def bias_after(weight: torch.Tensor) -> bool:
    """Whether a conv or Linear on ``weight`` adds its bias to its rounded
    product, as flax's layers do in their ``dtype``: below float32, where
    that rounding shows (PyTorch's cuDNN path adds it so on the card;
    oneDNN on the CPU would fold it into the float32 accumulation).  In
    float32 and wider the bias stays inside the product, the faster
    kernel, within float32 rounding of flax's."""
    return weight.dtype.itemsize < 4


def add_bias(y: torch.Tensor, bias) -> torch.Tensor:
    """``y`` (N, C, ...) plus ``bias`` (C,) in y's type."""
    if bias is None:
        return y
    return y + bias.to(y.dtype).reshape((-1,) + (1,) * (y.dim() - 2))


class Linear(nn.Linear):
    """``nn.Linear`` with the dtype semantics of flax's ``nn.Dense`` built
    with a ``dtype``: the input cast to the weight's type, the bias added
    to the rounded product below float32 (:func:`bias_after`)."""

    def forward(self, x):
        x = x.to(self.weight.dtype)
        if not bias_after(self.weight) or self.bias is None:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x, self.weight) + self.bias


class Conv2d(FlaxConv, nn.Conv2d):
    """``nn.Conv2d`` with flax's dtype semantics (:class:`FlaxConv`)."""


class Conv3x3K7(Conv2d):
    """3x3 stride-1 padding-1 ``nn.Conv2d`` whose forward and input
    gradient run on K7 (``ops/pallas_conv.py``) wherever the JAX routing
    gate :func:`pallas_conv.supports` holds for the input, and on
    ``nn.Conv2d`` elsewhere, as ``layers.py:74-84`` of the JAX package
    routes."""

    def forward(self, x):
        if not pallas_conv.supports(x.shape, self.out_channels):
            return super().forward(x)
        return add_bias(pallas_conv.conv3x3(x.to(self.weight.dtype),
                                            self.weight), self.bias)


class Conv3d(FlaxConv, nn.Conv3d):
    """``nn.Conv3d`` on ``(B, C, Y, X, Z)`` tensors with flax's dtype
    semantics (:class:`FlaxConv`).  With ``row_split``
    (module docstring) and an active row split, x is this rank's Y rows
    and so is the result: the conv fetches the rows its window reaches
    beyond them (``padding`` before, ``k - stride - padding`` after: one
    each side for a 3x3x3 stride-1 conv, one before for a stride-2 one;
    zeros at the grid's own edges, the conv's padding) and runs with no
    Y padding.  A 1x1x1 conv is row-local."""

    row_split = False

    def forward(self, x):
        x = x.to(self.weight.dtype)
        axis = parallel.row_axis() if self.row_split else None
        if axis is None or self.kernel_size[0] == 1:
            return self.conv(x)
        return self.conv_rows(x, axis)

    def conv(self, x):
        """The conv of a whole grid (or of rows and their halo, padded)."""
        return super().forward(x)

    def halo_rows(self) -> Tuple[int, int]:
        """The rows this conv's window reaches before and after a rank's
        rows of the nested split."""
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        assert self.dilation[0] == 1, self.dilation
        return p, max(k - s - p, 0)

    def conv_rows(self, x, axis):
        xe = parallel.halo(x, 2, *self.halo_rows(), axis)
        after = bias_after(self.weight)
        y = F.conv3d(xe, self.weight, None if after else self.bias,
                     self.stride, (0,) + tuple(self.padding[1:]),
                     self.dilation, self.groups)
        return add_bias(y, self.bias) if after else y


class Conv3dZSlabK7(Conv3d):
    """3x3x3 stride-1 padding-1 ``nn.Conv3d`` on ``(B, C, Y, X, Z)``
    tensors as the JAX package's stride-1 z-slab decomposition
    (``Conv3DZSlab``, ``layers.py:136-183``): three z-shifted 3x3 2D convs
    over the ``(B*Z, C, Y, X)`` slabs, summed in the input's type, each on
    K7 (forward and input gradient) where :func:`pallas_conv.supports`
    holds for a slab, and ``nn.Conv3d`` elsewhere.  On split rows it runs
    on the rows and their halo (one each side), padded, and crops."""

    def conv_rows(self, x, axis):
        lo, hi = self.halo_rows()  # (1, 1)
        y = self.conv(parallel.halo(x, 2, lo, hi, axis))
        return y[:, :, lo:y.shape[2] - hi]

    def conv(self, x):
        B, C, Y, X, Z = x.shape
        if not pallas_conv.supports((B * Z, C, Y, X), self.out_channels):
            return nn.Conv3d.forward(self, x)
        # (B, Z+2, Y, X, C) contiguous: each slab is a free channels-last
        # view, the memory K7 reads
        xp = F.pad(x, (1, 1)).permute(0, 4, 2, 3, 1).contiguous()
        out = None
        for dz in range(3):
            xs = xp[:, dz:dz + Z].reshape(B * Z, Y, X, C).permute(0, 3, 1, 2)
            y = pallas_conv.conv3x3(xs, self.weight[..., dz])
            y = y.permute(0, 2, 3, 1).reshape(B, Z, Y, X, -1)
            out = y if out is None else out + y
        return add_bias(out.permute(0, 4, 2, 3, 1), self.bias)


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

    def conv(self, x):
        B, C, Y, X, Z = x.shape
        if not self.training and conv3d_k6.supports((B, Y, X, Z, C),
                                                    self.out_channels):
            return add_bias(conv3d_k6.conv3d_3x3x3(x, self.weight),
                            self.bias)
        if self.zslab:
            return super().conv(x)
        return nn.Conv3d.forward(self, x)

    def conv_rows(self, x, axis):
        # zero rows after the halo, where they bring the rows to a size
        # K6's gate takes, reach no output row that is kept
        xe = parallel.halo(x, 2, 1, 1, axis)
        B, C, Y, X, Z = xe.shape
        extra = 0 if self.training else k6_rows((B, Y, X, Z, C),
                                                self.out_channels)
        y = self.conv(F.pad(xe, (0, 0, 0, 0, 0, extra)) if extra else xe)
        return y[:, :, 1:1 + x.shape[2]]


def k6_rows(shape: Sequence[int], cout: int) -> int:
    """The zero rows :class:`Conv3dK6` appends to a rank's rows and halo,
    channels-last ``shape`` (B, Y, X, Z, C), so that K6's gate takes them
    (an odd Y, 11 at space=3's 9-row coarse rank, is no multiple of a tile
    edge; Y + 1 is even): 0 or 1, and 0 where neither is taken."""
    B, Y, X, Z, C = shape
    for k in (0, 1):
        if conv3d_k6.supports((B, Y + k, X, Z, C), cout):
            return k
    return 0


def conv(ndim: int, cin: int, cout: int, k: int, stride: int = 1,
         padding: int = 0, dilation: int = 1, bias: bool = False,
         pallas3x3: bool = False, pallas_conv3d: bool = False):
    """``nn.Conv2d`` or :class:`Conv3d` with explicit integer padding.  A
    3x3(x3) stride-1 padding-1 undilated conv is, with ``pallas_conv3d``, a
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
    cls = Conv2d if ndim == 2 else Conv3d
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
    ``nn.BatchNorm``, training needs more than one value per channel.

    Under an active mesh the batch statistics are those of every rank
    that holds other images (``m.camera_split``: the image stage), other
    BEV rows (``m.row_split``: the stages behind the row split) or other
    samples (the rest): ``parallel.sync_batch_norm``, the global-batch
    statistics of JAX's jit over a sharded batch."""
    move = dim % x.ndim != 1
    if move:
        x = x.movedim(dim, 1)
    axis = (parallel.bn_axis(parallel.active_mesh(),
                             m.camera_split or m.row_split)
            if m.training else None)
    if not m.training:
        y = F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                         False, 0.0, m.eps)
    elif axis is not None:
        y, mean, var = parallel.sync_batch_norm(x, m.weight, m.bias, m.eps,
                                                axis)
        if m.update_stats:
            with torch.no_grad():
                m.running_mean.mul_(1.0 - m.momentum).add_(
                    mean, alpha=m.momentum)
                m.running_var.mul_(1.0 - m.momentum).add_(
                    var, alpha=m.momentum)
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
    camera_split = False  # in the per-camera image stage (FBOCC sets it)
    row_split = False  # behind the BEV row split (FBOCC sets it)

    def float32_islands(self):
        """Itself: flax's BatchNorm keeps its scale, shift and statistics
        in float32 and normalises a bf16 input in float32, rounding only
        its result to the input's type; so does ``F.batch_norm`` on float32
        parameters."""
        return [self]

    def forward(self, x):
        return batch_norm(self, x, 1)


def cast_with_islands(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every floating parameter and buffer of ``model`` cast to ``dtype``,
    except the float32 islands that its modules declare with a
    ``float32_islands()`` method (modules, or single parameters): what the
    JAX package keeps and computes with in float32 in a bf16 model -- every
    BatchNorm (:class:`BatchNorm`) and :class:`LayerNorm`, the BEVFormer
    embeddings, the depth net's camera branch, ConvNeXt's layer scales and
    Swin's bias tables.  Islands take float32 or ``dtype`` where that is
    wider (float64).  Each tensor is cast once from its own values: an
    island never passes through ``dtype``."""
    wide = torch.promote_types(torch.float32, dtype)
    keep = set()
    for mod in model.modules():
        for m in getattr(mod, "float32_islands", list)():
            ts = ([m] if isinstance(m, nn.Parameter)
                  else list(m.parameters()) + list(m.buffers()))
            keep.update(id(t) for t in ts)
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(wide if id(t) in keep else dtype)
    return model


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
        # a float32 x (the depth net's residual stream in a bf16 model)
        # stays float32 in the residual sum (the convs cast it)
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
        """x (B, C, H, W); x_se (B, C).  The gate keeps the type of its
        weights: float32 ones (the depth net's islands) make the product
        float32, as JAX's product of a bf16 x and a float32 gate is."""
        se = F.linear(x_se, self.conv_reduce.weight[:, :, 0, 0],
                      self.conv_reduce.bias)
        se = F.linear(F.relu(se), self.conv_expand.weight[:, :, 0, 0],
                      self.conv_expand.bias)
        return x * torch.sigmoid(se)[:, :, None, None]


def max_pool_same(x, window: int, strides: int):
    """Torch-style max pool with symmetric ``(window-1)//2`` padding."""
    return F.max_pool2d(x, window, strides, (window - 1) // 2)


def max_pool_ceil(x, window: int, strides: int):
    """``MaxPool2d(window, strides, ceil_mode=True)`` with padding 0 (the
    VoVNet inter-stage pools): the JAX package's ``max_pool_ceil``
    (``layers.py:484``), which pads only right and bottom, with -inf,
    exactly enough for the ceil-division output size."""
    return F.max_pool2d(x, window, strides, 0, ceil_mode=True)


def same_pad(x, k: int, s: int):
    """x (B, C, H, W) zero-padded as flax's ``SAME`` pads a ``k`` x ``k``
    stride-``s`` conv: ``ceil(n / s)`` outputs, the total padding split
    low ``total // 2``, high the rest (the patchify convs of ConvNeXt and
    Swin, whose JAX convs take flax's default padding)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def cast_in(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``m(x)`` with x cast to ``m``'s weight type, as a flax layer built
    with ``dtype`` casts its input (a float32 LayerNorm output entering a
    bf16 model's dense layer)."""
    return m(x.to(m.weight.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last axis computed in float32 with a
    float32 result, as flax's ``nn.LayerNorm`` without a ``dtype``
    computes and returns on float32 parameters; its parameters are kept in
    float32 under a bf16 model (:meth:`FBOCC.cast`)."""

    def float32_islands(self):
        return [self]

    def forward(self, x):
        t = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(t), self.normalized_shape,
                            self.weight.to(t), self.bias.to(t), self.eps)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax as ``jax.nn.softmax`` computes it in x's type: below
    float32, ``x - max``, its exp and the quotient by their sum each
    rounded to x's type (the sum taken in float32, as ``jnp.sum`` upcasts
    a bf16 reduction), three roundings where ``torch.softmax`` makes one;
    in float32 and wider ``torch.softmax``, within float32 rounding of
    it."""
    if x.dtype.itemsize >= 4:
        return torch.softmax(x, dim)
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True, dtype=torch.float32).to(e.dtype)


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
    # one edge-padded copy; prev, x and next are views of it, as JAX's
    xe = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)],
                   axis)

    def rnd(w: float) -> float:
        return float(torch.tensor(w, dtype=x.dtype))

    phases = []
    for k in range(s):
        c = (k + 0.5) / s - 0.5
        # lerp(prev, x, c + 1) before the sample's centre, else
        # lerp(x, next, c)
        i0, w = (0, c + 1.0) if c < 0 else (1, c)
        phases.append(rnd(1.0 - w) * xe.narrow(axis, i0, n)
                      + rnd(w) * xe.narrow(axis, i0 + 1, n))
    shape = list(x.shape)
    shape[axis] *= s
    return torch.stack(phases, dim=axis + 1).reshape(shape)


# the input rows an integer-factor linear upsample reads beyond an output
# row range's own, each side
UPSAMPLE_HALO = 1


def resize_trilinear(x, out_size: Sequence[int], rows: bool = False):
    """Trilinear resize of ``(B, C, D, H, W)`` with half-pixel centres and
    edge clamp (align_corners=False), the JAX package's
    ``resize_trilinear`` (``layers.py:607``).  Below float32 at integer
    factors, its rounding: a 2-tap lerp per axis (:func:`upsample_int_axis`),
    W first, then H, then D, each rounded in x's type; in float32 and wider
    (and at other sizes) ``F.interpolate``, one rounding, within float32
    rounding of the chain.  With ``rows`` and an active row split, x and
    the result are this rank's rows of D (the BEV Y axis, an integer factor
    finer in the result): D is upsampled by :func:`upsample_int_axis` on
    the rows with one halo row of each neighbour (the edge row repeated at
    the grid's own edges: the clamp) and cropped."""
    factors = [o // n if o % n == 0 else 0
               for o, n in zip(out_size, x.shape[2:])]
    axis = parallel.row_axis() if rows else None
    if x.dtype.itemsize >= 4 or not all(factors):
        if axis is None:
            return F.interpolate(x, size=tuple(out_size), mode="trilinear",
                                 align_corners=False)
        x = _upsample_rows(x, factors[0], axis)
        if tuple(x.shape[3:]) == tuple(out_size[1:]):
            return x
        return F.interpolate(x, size=tuple(out_size), mode="trilinear",
                             align_corners=False)
    x = upsample_int_axis(upsample_int_axis(x, 4, factors[2]), 3,
                          factors[1])
    if axis is None:
        return upsample_int_axis(x, 2, factors[0])
    return _upsample_rows(x, factors[0], axis)


def _upsample_rows(x, s: int, axis):
    """D of this rank's rows upsampled ``s`` times on the rows and one
    clamped halo row each side, cropped (:func:`resize_trilinear`)."""
    if not s:
        raise ValueError(f"split rows {x.shape[2]}: not an integer factor")
    if s == 1:
        return x
    n = x.shape[2]
    x = upsample_int_axis(parallel.halo(
        x, 2, UPSAMPLE_HALO, UPSAMPLE_HALO, axis, clamp=True), 2, s)
    return x[:, :, s * UPSAMPLE_HALO:s * (UPSAMPLE_HALO + n)]


class TimeEmbedConvBN(nn.Sequential):
    """SoloFusion time-embedding conv ``Sequential(Conv3d(C+1, F, 1),
    BN, ReLU)`` applied to ``concat([x, e])`` without the concat:
    ``x @ k[:C] + e * k[C] + bias``.  Channels-last ``(..., C)`` input."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv3d(cin + 1, cout, 1, bias=True),
                         bn(3, cout), nn.ReLU())

    def float32_islands(self):
        """The conv's kernel and bias stay float32 in a bf16 model and are
        cast at use, as flax's: the K1 epilogue folds the eval BatchNorm
        into them from their float32 values, as JAX's does
        (``fbocc.py:388-398``)."""
        return [self[0]]

    def kernel(self) -> torch.Tensor:
        """(C+1, F) matrix of the 1x1x1 conv."""
        return self[0].weight[:, :, 0, 0, 0].t()

    def forward(self, x, e):
        k = self.kernel().to(x.dtype)
        y = x @ k[:-1] + e.to(x.dtype) * k[-1] + self[0].bias.to(x.dtype)
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
