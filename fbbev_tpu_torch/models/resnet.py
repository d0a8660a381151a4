"""ResNet image backbone (torchvision layout, NCHW).  Counterpart of
``fbbev_tpu/models/resnet.py`` at the FB-OCC config: returns the C4 and
C5 stages (strides 16 and 32) of a ResNet-10/18/34 (basic blocks) or
ResNet-50/101 (bottlenecks), the depths of ``_STAGE_BLOCKS`` there.

``pallas3x3`` routes the stride-1 3x3 convs to K7; ``remat`` checkpoints
each stage in training (the config's ``remat=True``; the backward
recomputes the stage)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fbbev_tpu_torch.models.layers import BasicBlock, Bottleneck, bn, \
    checkpoint_stage, conv, max_pool_same
from fbbev_tpu_torch.registry import BACKBONES

# depth -> (bottleneck blocks?, blocks per stage)
STAGE_BLOCKS = {10: (False, (1, 1, 1, 1)), 18: (False, (2, 2, 2, 2)),
                34: (False, (3, 4, 6, 3)), 50: (True, (3, 4, 6, 3)),
                101: (True, (3, 4, 23, 3))}


def out_channels(depth: int):
    """Channels of the C4 and C5 outputs (the FPN's inputs)."""
    return (1024, 2048) if STAGE_BLOCKS[depth][0] else (256, 512)


@BACKBONES.register
class ResNet(nn.Module):
    def __init__(self, pallas3x3: bool = False, remat: bool = False,
                 depth: int = 50):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise KeyError(f"ResNet depth {depth}; one of "
                           f"{sorted(STAGE_BLOCKS)}")
        bottleneck, blocks_per_stage = STAGE_BLOCKS[depth]
        self.depth = depth
        self.remat = remat
        self.conv1 = conv(2, 3, 64, 7, 2, 3)
        self.bn1 = bn(2, 64)
        cin, planes = 64, 64
        for i, n in enumerate(blocks_per_stage):
            blocks = []
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                if bottleneck:
                    blocks.append(Bottleneck(cin, planes, stride, pallas3x3))
                    cin = planes * Bottleneck.expansion
                else:
                    blocks.append(BasicBlock(cin, planes, stride,
                                             pallas3x3=pallas3x3))
                    cin = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x):
        x = max_pool_same(F.relu(self.bn1(self.conv1(x))), 3, 2)
        run = (checkpoint_stage
               if self.remat and self.training and torch.is_grad_enabled()
               else (lambda stage, x: stage(x)))
        c4 = run(self.layer3, run(self.layer2, run(self.layer1, x)))
        return [c4, run(self.layer4, c4)]
