"""ConvNeXt image backbone, NCHW.  Counterpart of
``fbbev_tpu/models/convnext.py``: a 4x4 patchify stem + LayerNorm, stages
of blocks (depthwise 7x7 -> LayerNorm (eps 1e-6) -> Linear -> exact-erf
GELU -> Linear, scaled by the layer-scale ``gamma``, plus the input),
LayerNorm + 2x2 stride-2 conv between stages, LayerNorm-ed stage outputs.

Names are the reference's (``downsample_layers.{i}.{0,1}``,
``stages.{i}.{j}.{depthwise_conv,norm,pointwise_conv1,pointwise_conv2,
gamma}``, ``norm{i}``).  The dtype flow is flax's: the LayerNorms compute
and return float32 (:class:`layers.LayerNorm`), each conv / Linear casts
its input to the model's type, ``gamma`` stays float32, so a block's sum
is float32 wherever one of its terms is."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fbbev_tpu_torch.models.layers import Conv2d, LayerNorm, cast_in, \
    same_pad
from fbbev_tpu_torch.registry import BACKBONES

SPECS = {
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
}
LAYER_SCALE_INIT = 1e-6


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.depthwise_conv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pointwise_conv1 = nn.Linear(dim, 4 * dim)
        self.pointwise_conv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))

    def forward(self, x):
        y = cast_in(self.depthwise_conv, x).permute(0, 2, 3, 1)
        y = F.gelu(cast_in(self.pointwise_conv1, self.norm(y)))
        y = cast_in(self.pointwise_conv2, y)
        return x + (self.gamma * y).permute(0, 3, 1, 2)


def norm_nchw(m: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A channel LayerNorm of NCHW ``x``."""
    return m(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


@BACKBONES.register
class ConvNeXt(nn.Module):
    """The stage outputs of ``out_indices``, LayerNorm-ed (float32)."""

    def __init__(self, arch: str = "base", out_indices=(2, 3)):
        super().__init__()
        spec = SPECS[arch]
        self.arch = arch
        self.out_indices = tuple(out_indices)
        dims = spec["dims"]
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            Conv2d(3, dims[0], 4, stride=4), LayerNorm(dims[0], eps=1e-6))])
        for i in range(1, len(dims)):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm(dims[i - 1], eps=1e-6),
                Conv2d(dims[i - 1], dims[i], 2, stride=2)))
        self.stages = nn.ModuleList(
            nn.Sequential(*(ConvNeXtBlock(d) for _ in range(n)))
            for n, d in zip(spec["depths"], dims))
        for i in self.out_indices:
            setattr(self, f"norm{i}", LayerNorm(dims[i], eps=1e-6))

    def float32_islands(self):
        """The layer scales, float32 in a bf16 model (the LayerNorms
        declare themselves)."""
        return [b.gamma for s in self.stages for b in s]

    def forward(self, x):
        outs = []
        for i, (down, stage) in enumerate(zip(self.downsample_layers,
                                              self.stages)):
            if i == 0:
                x = norm_nchw(down[1], cast_in(down[0], same_pad(x, 4, 4)))
            else:
                x = cast_in(down[1], same_pad(norm_nchw(down[0], x), 2, 2))
            x = stage(x)
            if i in self.out_indices:
                outs.append(norm_nchw(getattr(self, f"norm{i}"), x))
        return outs
