"""FRPN: the BEV foreground mask head (the FB-BEV paper's query-pruning
mask).  Counterpart of ``fbbev_tpu/models/frpn.py``.  Every shipped
config disables it and ``models/builder.py`` drops a config's ``frpn``
key, as in the JAX package: it is on no model path.

``mask_net`` is the reference's ``Sequential(Conv2d 3x3, BatchNorm2d,
ReLU, Conv2d 3x3 -> 1)``; the first conv has no bias, as JAX's ``ConvBN``
(``use_bias=False``).  Loss: BCE with logits (``pos_weight`` 2.13) +
dice.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from fbbev_tpu_torch.models.layers import Conv2d, bn, conv
from fbbev_tpu_torch.registry import HEADS


@HEADS.register
class FRPN(nn.Module):
    def __init__(self, in_channels: int = 512, mask_thre: float = 0.4,
                 pallas3x3: bool = False):
        super().__init__()
        self.mask_thre = mask_thre
        mid = in_channels // 2
        self.mask_net = nn.Sequential(
            conv(2, in_channels, mid, 3, padding=1, pallas3x3=pallas3x3),
            bn(2, mid), nn.ReLU(),
            Conv2d(mid, 1, 3, padding=1, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) BEV feature -> (B, H, W) float32 mask logits."""
        return self.mask_net(x)[:, 0].float()


def bev_mask_loss(gt_mask: torch.Tensor, logits: torch.Tensor,
                  pos_weight: float = 2.13) -> Dict[str, torch.Tensor]:
    """BCE (pos-weighted, mean over all elements) + dice loss on the BEV
    mask: ``mask_ce_loss``, ``mask_dice_loss``."""
    gt = gt_mask.float()
    logits = logits.float()
    # torch BCEWithLogitsLoss(pos_weight=w): mean of
    #   w*y*softplus(-x) + (1-y)*softplus(x)
    ce = pos_weight * gt * F.softplus(-logits) + \
        (1.0 - gt) * F.softplus(logits)
    p = torch.sigmoid(logits).reshape(logits.shape[0], -1)
    g = gt.reshape(gt.shape[0], -1)
    eps = 1e-5
    dice = 1.0 - (2.0 * (p * g).sum(-1) + eps) / (p.sum(-1) + g.sum(-1)
                                                   + eps)
    return {"mask_ce_loss": ce.mean(), "mask_dice_loss": dice.mean()}
