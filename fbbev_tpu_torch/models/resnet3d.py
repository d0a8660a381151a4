"""3D ResNet BEV-voxel encoder.  Counterpart of
``fbbev_tpu/models/resnet3d.py::CustomResNet3D`` at the FB-OCC config
(depth 18: two basic blocks per stage, strides 1/2/2, every stage out).
``pallas3x3`` routes the stride-1 3x3x3 convs to K7 through the z-slab
decomposition; ``pallas_conv3d`` routes them to K6 in eval (10 at the
flagship).  Takes and returns ``(B, C, Y, X, Z)`` tensors: under an
active row split (its convs marked ``row_split`` by ``FBOCC``) this
rank's Y rows of each level, the stride-2 convs reading one halo row of
the rank before (``layers.Conv3d``)."""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from fbbev_tpu_torch.models.layers import BasicBlock, conv_bn_relu


class CustomResNet3D(nn.Module):
    def __init__(self, in_channels: int,
                 block_inplanes: Sequence[int] = (64, 128, 256),
                 pallas3x3: bool = False, pallas_conv3d: bool = False):
        super().__init__()
        c = block_inplanes[0]
        self.input_proj = conv_bn_relu(3, in_channels, c, 1)
        stages = []
        for planes, stride in zip(block_inplanes, (1, 2, 2)):
            stages.append(nn.Sequential(
                BasicBlock(c, planes, stride, ndim=3, bias=True,
                           pallas3x3=pallas3x3, pallas_conv3d=pallas_conv3d),
                BasicBlock(planes, planes, 1, ndim=3, bias=True,
                           pallas3x3=pallas3x3,
                           pallas_conv3d=pallas_conv3d)))
            c = planes
        self.layers = nn.ModuleList(stages)

    def forward(self, x):
        x = self.input_proj(x)
        outs = []
        for stage in self.layers:
            x = stage(x)
            outs.append(x)
        return outs
