"""VoVNet (V2, eSE) image backbone, NCHW.  Counterpart of
``fbbev_tpu/models/vovnet.py`` (the large FB-OCC variant's backbone,
VoVNet-99 at 512x1408): a stem of three 3x3 ConvBN (strides 2, 1, 2),
then four stages of one-shot-aggregation (OSA) blocks -- ``layer_per_block``
3x3 ConvBN whose outputs are concatenated with the block's input and
reduced by a 1x1 ConvBN, effective squeeze-excitation (eSE), identity on
every block but a stage's first -- with a ceil-mode 3x3 stride-2 max pool
before stages 3-5 (the reference's parameter-free ``stage{n}.Pooling``).

Module names are the reference's (``stem.stem_1/conv``,
``stage{n}.OSA{n}_{b}.layers.{i}.OSA{n}_{b}_{i}/conv``, ``...concat...``,
``...ese.fc``), so the converted state dict loads with ``strict=True``.
``pallas3x3`` sends the 3x3 stride-1 convs to K7 where its gate holds
(``layers.conv``); ``remat`` checkpoints each OSA block in training, as
the JAX package's ``nn.remat(OSAModule)`` does."""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn

from fbbev_tpu_torch.models.layers import Conv2d, bn, checkpoint_stage, \
    conv, max_pool_ceil
from fbbev_tpu_torch.registry import BACKBONES

STAGE_SPECS = {
    "V-19-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=3,
                     block_per_stage=(1, 1, 1, 1)),
    "V-39-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 1, 2, 2)),
    "V-57-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 1, 4, 3)),
    "V-99-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 3, 9, 3)),
}


def named_conv_bn_relu(name: str, cin: int, cout: int, k: int,
                       stride: int = 1, pallas3x3: bool = False):
    """The reference's ``conv3x3`` / ``conv1x1`` items: ``{name}/conv``,
    ``{name}/norm``, ``{name}/relu``."""
    return [(f"{name}/conv", conv(2, cin, cout, k, stride, k // 2,
                                  pallas3x3=pallas3x3)),
            (f"{name}/norm", bn(2, cout)), (f"{name}/relu", nn.ReLU())]


class ESEModule(nn.Module):
    """Effective squeeze-excitation: ``x * hsigmoid(fc(mean(x)))``, the
    hard sigmoid ``clip(s / 6 + 0.5, 0, 1)``, all in x's type."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1, bias=True)

    def forward(self, x):
        s = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * torch.clamp(s / 6.0 + 0.5, 0.0, 1.0)


class OSAModule(nn.Module):
    def __init__(self, name: str, cin: int, stage_ch: int, concat_ch: int,
                 layer_per_block: int, identity: bool = False,
                 pallas3x3: bool = False):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList()
        c = cin
        for i in range(layer_per_block):
            self.layers.append(nn.Sequential(OrderedDict(named_conv_bn_relu(
                f"{name}_{i}", c, stage_ch, 3, pallas3x3=pallas3x3))))
            c = stage_ch
        self.concat = nn.Sequential(OrderedDict(named_conv_bn_relu(
            f"{name}_concat", cin + layer_per_block * stage_ch, concat_ch,
            1)))
        self.ese = ESEModule(concat_ch)

    def forward(self, x):
        outputs = [x]
        y = x
        for layer in self.layers:
            y = layer(y)
            outputs.append(y)
        y = self.ese(self.concat(torch.cat(outputs, dim=1)))
        return y + x if self.identity else y


@BACKBONES.register
class VoVNetCP(nn.Module):
    """The stage outputs of ``out_indices`` (0..3 for stages 2..5)."""

    def __init__(self, spec_name: str = "V-99-eSE", out_indices=(2, 3),
                 pallas3x3: bool = False, remat: bool = False):
        super().__init__()
        spec = STAGE_SPECS[spec_name]
        self.spec_name = spec_name
        self.out_indices = tuple(out_indices)
        self.remat = remat
        s1, s2, s3 = spec["stem"]
        self.stem = nn.Sequential(OrderedDict(
            named_conv_bn_relu("stem_1", 3, s1, 3, 2)
            + named_conv_bn_relu("stem_2", s1, s2, 3, 1, pallas3x3)
            + named_conv_bn_relu("stem_3", s2, s3, 3, 2)))
        cin = s3
        for stage in range(4):
            n = stage + 2
            blocks = OrderedDict()
            for b in range(spec["block_per_stage"][stage]):
                blocks[f"OSA{n}_{b + 1}"] = OSAModule(
                    f"OSA{n}_{b + 1}", cin, spec["stage_conv_ch"][stage],
                    spec["stage_out_ch"][stage], spec["layer_per_block"],
                    identity=b > 0, pallas3x3=pallas3x3)
                cin = spec["stage_out_ch"][stage]
            setattr(self, f"stage{n}", nn.Sequential(blocks))

    def forward(self, x):
        x = self.stem(x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        for stage in range(4):
            if stage > 0:
                x = max_pool_ceil(x, 3, 2)
            for block in getattr(self, f"stage{stage + 2}"):
                x = checkpoint_stage(block, x) if remat else block(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs
