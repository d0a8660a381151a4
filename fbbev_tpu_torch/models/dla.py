"""DLA-34 (Deep Layer Aggregation) image backbone, NCHW.  Counterpart of
``fbbev_tpu/models/dla.py``: a 7x7 base layer, two plain conv levels,
then ``Tree`` levels 2-5.  A level-root tree appends its (max-pooled)
input to its root's concat; a block adds the tree's external identity
(the projected bottom), as the reference's ``BasicBlock.forward(x,
identity)``; a ``Root`` is a 1x1 ConvBN over ``concat([x2, x1,
*children])``.

Names are the reference's (``base_layer.{0,1}``, ``level{0,1}.{0,1}``,
``level{2..5}.(project.{0,1}|tree1|tree2|root.{conv,norm})``, blocks
``conv1``/``norm1``/``conv2``/``norm2``).  A tree of more than one level
computes its projection only where the JAX package does so and it counts:
in training, where its BatchNorm's statistics move (JAX builds it and
drops its output).  ``pallas3x3`` sends the 3x3 stride-1 convs to K7
where its gate holds."""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fbbev_tpu_torch.models.layers import bn, conv, conv_bn_relu, \
    max_pool_same
from fbbev_tpu_torch.registry import BACKBONES

SPECS = {
    "dla34": dict(levels=(1, 1, 1, 2, 2, 1),
                  channels=(16, 32, 64, 128, 256, 512),
                  level_roots=(False, True, True, True)),
}


class DLABasicBlock(nn.Module):
    """Two 3x3 ConvBN; the residual is the identity the tree passes in."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 pallas3x3: bool = False):
        super().__init__()
        self.conv1 = conv(2, cin, cout, 3, stride, 1, pallas3x3=pallas3x3)
        self.norm1 = bn(2, cout)
        self.conv2 = conv(2, cout, cout, 3, 1, 1, pallas3x3=pallas3x3)
        self.norm2 = bn(2, cout)

    def forward(self, x, identity):
        y = F.relu(self.norm1(self.conv1(x)))
        return F.relu(self.norm2(self.conv2(y)) + identity)


class Root(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = conv(2, cin, cout, 1)
        self.norm = bn(2, cout)

    def forward(self, children: List[torch.Tensor]):
        return F.relu(self.norm(self.conv(torch.cat(children, dim=1))))


class Tree(nn.Module):
    """``levels`` levels of blocks into ``cout`` channels; ``extra`` is
    the channel count of the children a parent tree hands in."""

    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, extra: int = 0,
                 pallas3x3: bool = False):
        super().__init__()
        self.levels, self.stride, self.level_root = levels, stride, level_root
        if level_root:
            extra += cin
        if levels == 1:
            self.tree1 = DLABasicBlock(cin, cout, stride, pallas3x3)
            self.tree2 = DLABasicBlock(cout, cout, 1, pallas3x3)
            self.root = Root(2 * cout + extra, cout)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride,
                              pallas3x3=pallas3x3)
            self.tree2 = Tree(levels - 1, cout, cout, extra=extra + cout,
                              pallas3x3=pallas3x3)
        self.project = (conv_bn_relu(2, cin, cout, 1, relu=False)
                        if cin != cout else None)

    def forward(self, x, children: Optional[List[torch.Tensor]] = None):
        children = [] if children is None else list(children)
        bottom = max_pool_same(x, self.stride, self.stride) \
            if self.stride > 1 else x
        identity = bottom
        if self.project is not None and (self.levels == 1 or self.training):
            identity = self.project(bottom)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, identity)
            x2 = self.tree2(x1, x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        return self.tree2(x1, children + [x1])


@BACKBONES.register
class DLANet(nn.Module):
    """The level outputs of ``out_indices`` (0..5)."""

    def __init__(self, arch: str = "dla34", out_indices=(4, 5),
                 pallas3x3: bool = False):
        super().__init__()
        spec = SPECS[arch]
        ch = spec["channels"]
        self.arch = arch
        self.out_indices = tuple(out_indices)
        self.base_layer = conv_bn_relu(2, 3, ch[0], 7, 1, 3)
        self.level0 = conv_bn_relu(2, ch[0], ch[0], 3, 1, 1,
                                   pallas3x3=pallas3x3)
        self.level1 = conv_bn_relu(2, ch[0], ch[1], 3, 2, 1)
        for lvl in range(2, 6):
            setattr(self, f"level{lvl}", Tree(
                spec["levels"][lvl], ch[lvl - 1], ch[lvl], 2,
                spec["level_roots"][lvl - 2], pallas3x3=pallas3x3))

    def forward(self, x):
        x = self.base_layer(x)
        outs = []
        for lvl in range(6):
            x = getattr(self, f"level{lvl}")(x)
            if lvl in self.out_indices:
                outs.append(x)
        return outs
