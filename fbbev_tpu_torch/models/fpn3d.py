"""3D FPN over voxel features.  Counterpart of
``fbbev_tpu/models/fpn3d.py::FPN3D``: 1x1x1 conv-BN-ReLU laterals,
trilinear top-down (align_corners=False), 3x3x3 conv-BN-ReLU outputs
(on K7 through the z-slab decomposition with ``pallas3x3``, on K6 in eval
with ``pallas_conv3d``).
``(B, C, Y, X, Z)`` tensors; with ``row_split`` (set by ``FBOCC``) each
level holds this rank's Y rows under an active row split, and the
top-down upsample and the output convs take their halos
(``layers.resize_trilinear``, ``layers.Conv3d``)."""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from fbbev_tpu_torch.models.layers import ConvModule, resize_trilinear


class FPN3D(nn.Module):
    row_split = False

    def __init__(self, in_channels: Sequence[int] = (64, 128, 256),
                 out_channels: int = 256, pallas3x3: bool = False,
                 pallas_conv3d: bool = False):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            nn.Sequential(ConvModule(3, c, out_channels, 1))
            for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            nn.Sequential(ConvModule(3, out_channels, out_channels, 3,
                                     padding=1, pallas3x3=pallas3x3,
                                     pallas_conv3d=pallas_conv3d))
            for _ in in_channels)

    def forward(self, inputs, n_out=None):
        """The output levels, the finest first; only the first ``n_out``
        (all by default): a model that reads the finest level alone (the
        detection head without the occupancy head) skips the other output
        convs, which XLA drops from the JAX package's compiled forward
        as dead code."""
        lat = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize_trilinear(
                lat[i], lat[i - 1].shape[2:], self.row_split)
        return [m(x) for m, x in zip(self.fpn_convs[:n_out], lat)]
