"""Swin Transformer image backbone, NCHW in, NCHW out.  Counterpart of
``fbbev_tpu/models/swin.py``: a 4x4 patch embedding + LayerNorm, stages of
windowed multi-head attention blocks (relative-position bias, every
second block shifted by half a window with the -100 mask), 2x2 patch
merging between stages, LayerNorm-ed stage outputs.  Windows are padded to
multiples of the window size.

Names are the reference's mmcv ones (``patch_embed.{projection,norm}``,
``stages.{i}.blocks.{j}.{norm1,attn.w_msa.{relative_position_bias_table,
qkv,proj},norm2,ffn.layers.0.0,ffn.layers.1}``,
``stages.{i}.downsample.{norm,reduction}``, ``norm{i}``).  The merge
flattens each 2x2 neighbourhood in the reference's unfold order (channel
``c*4 + dy*2 + dx``); the JAX package concatenates in ``(dy, dx, c)``, and
``weights.py`` permutes the merge's LayerNorm and reduction between the
two, as the JAX converter does.  The dtype flow is flax's: LayerNorms
compute and return float32, Linear layers cast their input to the model's
type, the attention logits are float32 through the softmax (JAX
``swin.py:55``), the bias table stays float32."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fbbev_tpu_torch.models.layers import Conv2d, LayerNorm, cast_in, \
    same_pad
from fbbev_tpu_torch.registry import BACKBONES

SPECS = {
    "tiny": dict(depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), embed=96),
    "small": dict(depths=(2, 2, 18, 2), heads=(3, 6, 12, 24), embed=96),
    "base": dict(depths=(2, 2, 18, 2), heads=(4, 8, 16, 32), embed=128),
}


def rel_pos_index(ws: int) -> torch.Tensor:
    """(ws*ws, ws*ws) rows of the bias table, the JAX ``_rel_pos_index``."""
    c = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                   indexing="ij")).reshape(2, -1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + ws - 1
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_mask(Hp: int, Wp: int, ws: int, shift: int,
               device) -> torch.Tensor:
    """(nW, ws*ws, ws*ws) float32 mask of a shifted block on an Hp x Wp
    padded map: -100 between tokens of different regions, else 0.  The
    regions are JAX's slices ``(0, -ws), (-ws, -shift), (-shift, None)``
    on each axis (``swin.py:95-104``)."""
    def regions(n):
        r = torch.zeros(n, dtype=torch.long, device=device)
        r[max(n - ws, 0):] = 1
        r[max(n - shift, 0):] = 2
        return r

    img = regions(Hp)[:, None] * 3 + regions(Wp)[None, :]
    mw = img.reshape(Hp // ws, ws, Wp // ws, ws).permute(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    return torch.where(mw[:, :, None] != mw[:, None, :], -100.0,
                       0.0).float()


class WindowMSA(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("rel_index", rel_pos_index(window),
                             persistent=False)

    def forward(self, x, mask=None):
        """x (nW, L, C); mask (nW_per_image, L, L) or None."""
        nW, L, C = x.shape
        h = self.heads
        qkv = cast_in(self.qkv, x).reshape(nW, L, 3, h, C // h)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q * (C // h) ** -0.5
        attn = (q @ k.transpose(-2, -1)).float()
        table = self.relative_position_bias_table.float()
        attn = attn + table[self.rel_index].permute(2, 0, 1)[None]
        if mask is not None:
            attn = (attn.reshape(-1, mask.shape[0], h, L, L)
                    + mask[None, :, None]).reshape(nW, h, L, L)
        out = torch.softmax(attn, dim=-1).to(v.dtype) @ v
        return cast_in(self.proj, out.transpose(1, 2).reshape(nW, L, C))


class ShiftWindowMSA(nn.Module):
    """mmcv's wrapper, named ``attn`` in a block: the window attention
    ``w_msa``."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.w_msa = WindowMSA(dim, heads, window)


class FFN(nn.Module):
    """mmcv's FFN: ``layers.0.0`` Linear, GELU, ``layers.1`` Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(nn.Linear(dim, hidden)),
                                    nn.Linear(hidden, dim))

    def forward(self, x):
        y = F.gelu(cast_in(self.layers[0][0], x))
        return cast_in(self.layers[1], y)


class SwinBlock(nn.Module):
    """One (shifted) window attention block on channels-last (B, H, W, C)."""

    def __init__(self, dim: int, heads: int, window: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, heads, window)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, int(dim * mlp_ratio))
        self._masks: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def mask(self, Hp: int, Wp: int, device) -> torch.Tensor:
        """The shift mask of an Hp x Wp padded map, built once per size and
        device."""
        key = (Hp, Wp, torch.device(device))
        if key not in self._masks:
            self._masks[key] = shift_mask(Hp, Wp, self.window, self.shift,
                                          device)
        return self._masks[key]

    def forward(self, x):
        B, H, W, C = x.shape
        ws, s = self.window, self.shift
        shortcut = x
        x = self.norm1(x)
        x = F.pad(x, (0, 0, 0, (-W) % ws, 0, (-H) % ws))
        Hp, Wp = x.shape[1:3]
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
        nh, nw = Hp // ws, Wp // ws
        xw = x.reshape(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(B * nh * nw, ws * ws, C)
        att = self.attn.w_msa(xw, self.mask(Hp, Wp, x.device) if s else None)
        x = att.reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, Hp, Wp, C)
        if s:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + x[:, :H, :W]
        return x + self.ffn(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbourhoods (bottom / right zero-padded to even) flattened in
    unfold order, LayerNorm, Linear reduction without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        """x (B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C)."""
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        Ho, Wo = x.shape[1] // 2, x.shape[2] // 2
        x = x.reshape(B, Ho, 2, Wo, 2, C).permute(0, 1, 3, 5, 2, 4)
        return cast_in(self.reduction,
                       self.norm(x.reshape(B, Ho, Wo, 4 * C)))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if b % 2 == 0 else window // 2)
            for b in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.projection = Conv2d(3, dim, 4, stride=4)
        self.norm = LayerNorm(dim, eps=1e-5)


@BACKBONES.register
class SwinTransformer(nn.Module):
    """The stage outputs of ``out_indices``, LayerNorm-ed (float32), NCHW."""

    def __init__(self, arch: str = "base", window: int = 7,
                 out_indices=(2, 3)):
        super().__init__()
        spec = SPECS[arch]
        self.arch = arch
        self.out_indices = tuple(out_indices)
        C = spec["embed"]
        self.patch_embed = PatchEmbed(C)
        n = len(spec["depths"])
        self.stages = nn.ModuleList(
            SwinStage(C * 2 ** i, depth, heads, window, i < n - 1)
            for i, (depth, heads) in enumerate(zip(spec["depths"],
                                                   spec["heads"])))
        for i in self.out_indices:
            setattr(self, f"norm{i}", LayerNorm(C * 2 ** i, eps=1e-5))

    def float32_islands(self):
        """The bias tables, float32 in a bf16 model (the LayerNorms
        declare themselves)."""
        return [m.relative_position_bias_table for m in self.modules()
                if isinstance(m, WindowMSA)]

    def forward(self, x):
        pe = self.patch_embed
        x = cast_in(pe.projection, same_pad(x, 4, 4)).permute(0, 2, 3, 1)
        x = pe.norm(x)
        outs = []
        for i, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = block(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
