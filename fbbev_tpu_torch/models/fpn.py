"""Single-output FPN over C4/C5 (NCHW).  Counterpart of
``fbbev_tpu/models/fpn.py::CustomFPN`` at the FB-OCC config: 1x1
laterals, nearest top-down add, a 3x3 conv on the finer level (K7 with
``pallas3x3``)."""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from fbbev_tpu_torch.models.layers import ConvModule, upsample_nearest


class CustomFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (1024, 2048),
                 out_channels: int = 256, pallas3x3: bool = False):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            ConvModule(2, c, out_channels, 1, bias=True, norm=False,
                       relu=False) for c in in_channels)
        self.fpn_convs = nn.ModuleList([
            ConvModule(2, out_channels, out_channels, 3, padding=1,
                       bias=True, norm=False, relu=False,
                       pallas3x3=pallas3x3)])

    def forward(self, inputs):
        lat = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + upsample_nearest(
                lat[i], lat[i - 1].shape[2:])
        return self.fpn_convs[0](lat[0])
