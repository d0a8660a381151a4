"""JAX variables -> the port's state dict.

The port's module names are the reference's torch names, so moving
weights from the JAX package is a relayout: its ``params`` /
``batch_stats`` trees (nested dicts of numpy arrays) become a flat state
dict in PyTorch layouts, loaded with ``load_state_dict(strict=True)``.
The rules are this package's own copy of the flagship FB-OCC rules of
``fbbev_tpu/train/checkpoint_convert.py`` and of its VoVNet, ConvNeXt,
Swin and DLA backbone rules (export direction), and rules of its own for
the detection heads (``pts_bbox_head``, ``FRPN``), for which that file has
none:

* conv kernel (kh, kw, I, O) / (kd, kh, kw, I, O) -> (O, I, k...)
* transposed-conv kernel (kd, kh, kw, I, O), stored unflipped for
  ``lax.conv_transpose`` -> torch ``ConvTranspose3d`` (I, O, kd, kh, kw)
  with the spatial flip torch's deconvolution semantics need
* dense (I, O) -> linear (O, I); a dense standing for a 1x1 conv gets
  trailing (1, 1)
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
* Swin's patch-merging LayerNorm and reduction: JAX's ``(dy, dx, c)``
  channel order -> the reference's unfold order ``c*4 + dy*2 + dx``
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fbbev_tpu_torch.models import convnext, dla, resnet, swin, vovnet
from fbbev_tpu_torch.models.centerpoint_head import BRANCHES


class _Exporter:
    def __init__(self, params: Dict[str, Any], batch_stats: Dict[str, Any]):
        self.trees = {"params": params, "batch_stats": batch_stats}
        self.sd: Dict[str, np.ndarray] = {}
        self.used = set()

    def _get(self, tree: str, path: Tuple[str, ...]) -> np.ndarray:
        d = self.trees[tree]
        for k in path:
            d = d[k]
        self.used.add((tree,) + tuple(path))
        return np.asarray(d, np.float32)

    def _has(self, path: Tuple[str, ...]) -> bool:
        d = self.trees["params"]
        for k in path:
            if not isinstance(d, dict) or k not in d:
                return False
            d = d[k]
        return True

    def _put(self, name: str, tree: str, path: Tuple[str, ...],
             relayout=None) -> None:
        """``sd[name]`` = the leaf at ``path`` of ``tree``, relaid out."""
        v = self._get(tree, path)
        self.sd[name] = v if relayout is None else relayout(v)

    def conv(self, src, dst, ndim=2):
        perm = (3, 2, 0, 1) if ndim == 2 else (4, 3, 0, 1, 2)
        self._put(src + ".weight", "params", dst + ("kernel",),
                  lambda k: np.transpose(k, perm))
        if self._has(dst + ("bias",)):
            self._put(src + ".bias", "params", dst + ("bias",))

    def deconv3d(self, src, dst):
        self._put(src + ".weight", "params", dst + ("kernel",),
                  lambda k: np.ascontiguousarray(np.transpose(
                      np.flip(k, (0, 1, 2)), (3, 4, 0, 1, 2))))

    def bn(self, src, dst):
        self._put(src + ".weight", "params", dst + ("scale",))
        self._put(src + ".bias", "params", dst + ("bias",))
        self._put(src + ".running_mean", "batch_stats", dst + ("mean",))
        self._put(src + ".running_var", "batch_stats", dst + ("var",))

    def linear(self, src, dst, conv1x1=False, rows=None):
        """``rows``: the kernel's input rows in the port's order."""
        def relayout(k):
            k = k if rows is None else k[rows]
            return k.T[:, :, None, None] if conv1x1 else k.T
        self._put(src + ".weight", "params", dst + ("kernel",), relayout)
        if self._has(dst + ("bias",)):
            self._put(src + ".bias", "params", dst + ("bias",))

    def layernorm(self, src, dst, rows=None):
        """``rows``: the channels in the port's order."""
        relayout = None if rows is None else (lambda v: v[rows])
        self._put(src + ".weight", "params", dst + ("scale",), relayout)
        self._put(src + ".bias", "params", dst + ("bias",), relayout)

    def raw(self, src, dst):
        self._put(src, "params", dst)

    def convbn(self, src_conv, src_bn, dst, ndim=2):
        self.conv(src_conv, dst + ("conv",), ndim)
        self.bn(src_bn, dst + ("bn",))


def resnet_rules(b, src: str, dst: Tuple[str, ...], blocks, convs: int):
    """ResNet stages: ``blocks`` blocks per stage, each of ``convs`` convs
    (3 for bottlenecks, 2 for basic blocks)."""
    b.convbn(f"{src}conv1", f"{src}bn1", dst + ("stem",))
    for stage, n in enumerate(blocks):
        for i in range(n):
            p = f"{src}layer{stage + 1}.{i}."
            d = dst + (f"layer{stage + 1}_{i}",)
            for c in range(1, convs + 1):
                b.convbn(f"{p}conv{c}", f"{p}bn{c}", d + (f"conv{c}",))
            if b._has(d + ("downsample", "conv", "kernel")):
                b.convbn(f"{p}downsample.0", f"{p}downsample.1",
                         d + ("downsample",))


def vovnet_rules(b, src: str, dst: Tuple[str, ...], blocks,
                 layers: int) -> None:
    """VoVNet (``checkpoint_convert.py:356``): ``blocks`` OSA blocks per
    stage of ``layers`` 3x3 ConvBN each."""
    for i in (1, 2, 3):
        b.convbn(f"{src}stem.stem_{i}/conv", f"{src}stem.stem_{i}/norm",
                 dst + (f"stem{i}",))
    for stage, nb in enumerate(blocks):
        n = stage + 2
        for k in range(nb):
            osa = f"OSA{n}_{k + 1}"
            p, d = f"{src}stage{n}.{osa}.", dst + (f"stage{n}_{k}",)
            for i in range(layers):
                q = f"{p}layers.{i}.{osa}_{i}"
                b.convbn(f"{q}/conv", f"{q}/norm", d + (f"conv{i}",))
            b.convbn(f"{p}concat.{osa}_concat/conv",
                     f"{p}concat.{osa}_concat/norm", d + ("concat",))
            b.conv(f"{p}ese.fc", d + ("ese", "fc"))


def convnext_rules(b, src: str, dst: Tuple[str, ...], depths,
                   out_indices) -> None:
    """ConvNeXt (``checkpoint_convert.py:386``)."""
    b.conv(f"{src}downsample_layers.0.0", dst + ("stem_conv",))
    b.layernorm(f"{src}downsample_layers.0.1", dst + ("stem_norm",))
    for i in range(1, len(depths)):
        b.layernorm(f"{src}downsample_layers.{i}.0", dst + (f"down{i}_norm",))
        b.conv(f"{src}downsample_layers.{i}.1", dst + (f"down{i}_conv",))
    for i, depth in enumerate(depths):
        for j in range(depth):
            p, d = f"{src}stages.{i}.{j}.", dst + (f"stage{i}_{j}",)
            b.conv(f"{p}depthwise_conv", d + ("dwconv",))
            b.layernorm(f"{p}norm", d + ("norm",))
            b.linear(f"{p}pointwise_conv1", d + ("pwconv1",))
            b.linear(f"{p}pointwise_conv2", d + ("pwconv2",))
            b.raw(f"{p}gamma", d + ("gamma",))
        if i in out_indices:
            b.layernorm(f"{src}norm{i}", dst + (f"out_norm{i}",))


def swin_merge_rows(C: int) -> np.ndarray:
    """The JAX channel of each of the port's 4C patch-merging channels:
    JAX concatenates a 2x2 neighbourhood as ``(dy, dx, c)``, the port in
    unfold order ``c*4 + dy*2 + dx`` (``checkpoint_convert.py:452-489``)."""
    o = np.arange(4 * C)
    return np.argsort((o % C) * 4 + (o // (2 * C)) * 2 + (o // C) % 2)


def swin_block_rules(b, src: str, dst: Tuple[str, ...]) -> None:
    """One ``SwinBlock``."""
    b.layernorm(f"{src}norm1", dst + ("norm1",))
    b.raw(f"{src}attn.w_msa.relative_position_bias_table",
          dst + ("attn", "rel_pos_bias"))
    b.linear(f"{src}attn.w_msa.qkv", dst + ("attn", "qkv"))
    b.linear(f"{src}attn.w_msa.proj", dst + ("attn", "proj"))
    b.layernorm(f"{src}norm2", dst + ("norm2",))
    b.linear(f"{src}ffn.layers.0.0", dst + ("mlp_fc1",))
    b.linear(f"{src}ffn.layers.1", dst + ("mlp_fc2",))


def swin_rules(b, src: str, dst: Tuple[str, ...], depths, embed: int,
               out_indices) -> None:
    """Swin (``checkpoint_convert.py:443``), the merges' LayerNorm and
    reduction rows permuted by :func:`swin_merge_rows`."""
    b.conv(f"{src}patch_embed.projection", dst + ("patch_embed",))
    b.layernorm(f"{src}patch_embed.norm", dst + ("patch_norm",))
    for i, depth in enumerate(depths):
        for j in range(depth):
            swin_block_rules(b, f"{src}stages.{i}.blocks.{j}.",
                             dst + (f"stage{i}_{j}",))
        if i < len(depths) - 1:
            rows = swin_merge_rows(embed * 2 ** i)
            ds = f"{src}stages.{i}.downsample."
            b.layernorm(f"{ds}norm", dst + (f"merge{i + 1}_norm",), rows=rows)
            b.linear(f"{ds}reduction", dst + (f"merge{i + 1}_reduce",),
                     rows=rows)
        if i in out_indices:
            b.layernorm(f"{src}norm{i}", dst + (f"out_norm{i}",))


def _dla_tree(b, src: str, dst: Tuple[str, ...], levels: int, cin: int,
              cout: int) -> None:
    if cin != cout:
        b.convbn(f"{src}project.0", f"{src}project.1", dst + ("project",))
    if levels == 1:
        for t in ("tree1", "tree2"):
            for c in (1, 2):
                b.convbn(f"{src}{t}.conv{c}", f"{src}{t}.norm{c}",
                         dst + (t, f"conv{c}"))
        b.convbn(f"{src}root.conv", f"{src}root.norm", dst + ("root", "conv"))
    else:
        _dla_tree(b, f"{src}tree1.", dst + ("tree1",), levels - 1, cin, cout)
        _dla_tree(b, f"{src}tree2.", dst + ("tree2",), levels - 1, cout,
                  cout)


def dla_rules(b, src: str, dst: Tuple[str, ...], levels, channels) -> None:
    """DLA (``checkpoint_convert.py:521-558``): the conv levels 0-1, then
    the trees of ``levels[2:]`` levels into ``channels[2:]``."""
    for name in ("base_layer", "level0", "level1"):
        b.convbn(f"{src}{name}.0", f"{src}{name}.1", dst + (name,))
    for lvl in range(2, 6):
        _dla_tree(b, f"{src}level{lvl}.", dst + (f"level{lvl}",),
                  levels[lvl], channels[lvl - 1], channels[lvl])


def backbone_rules(b, src: str, dst: Tuple[str, ...], spec: dict) -> None:
    """The rules of an image backbone of structure ``spec``
    (:func:`backbone_spec`, :func:`jax_backbone_spec`): port names
    prefixed by ``src``, JAX paths under ``dst``."""
    t = spec["type"]
    if t == "ResNet":
        resnet_rules(b, src, dst, spec["blocks"], spec["convs"])
    elif t == "VoVNetCP":
        vovnet_rules(b, src, dst, spec["blocks"], spec["layers"])
    elif t == "ConvNeXt":
        convnext_rules(b, src, dst, spec["depths"], spec["out_indices"])
    elif t == "SwinTransformer":
        swin_rules(b, src, dst, spec["depths"], spec["embed"],
                   spec["out_indices"])
    elif t == "DLANet":
        dla_rules(b, src, dst, spec["levels"], spec["channels"])
    else:
        raise KeyError(t)


def backbone_spec(m: torch.nn.Module) -> dict:
    """The structure :func:`backbone_rules` walks, read from a port
    backbone."""
    if isinstance(m, resnet.ResNet):
        return dict(type="ResNet",
                    blocks=tuple(len(getattr(m, f"layer{i}"))
                                 for i in range(1, 5)),
                    convs=3 if hasattr(m.layer1[0], "conv3") else 2)
    if isinstance(m, vovnet.VoVNetCP):
        s = vovnet.STAGE_SPECS[m.spec_name]
        return dict(type="VoVNetCP", blocks=tuple(s["block_per_stage"]),
                    layers=s["layer_per_block"])
    if isinstance(m, convnext.ConvNeXt):
        return dict(type="ConvNeXt",
                    depths=tuple(convnext.SPECS[m.arch]["depths"]),
                    out_indices=m.out_indices)
    if isinstance(m, swin.SwinTransformer):
        s = swin.SPECS[m.arch]
        return dict(type="SwinTransformer", depths=tuple(s["depths"]),
                    embed=s["embed"], out_indices=m.out_indices)
    if isinstance(m, dla.DLANet):
        s = dla.SPECS[m.arch]
        return dict(type="DLANet", levels=tuple(s["levels"]),
                    channels=tuple(s["channels"]))
    raise KeyError(type(m).__name__)


def _count(tree, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def _dla_jax_tree(tree) -> Tuple[int, int]:
    """(levels, output channels) of a JAX DLA ``Tree`` subtree."""
    if "root" in tree:
        return 1, tree["root"]["conv"]["conv"]["kernel"].shape[-1]
    levels, ch = _dla_jax_tree(tree["tree1"])
    return levels + 1, ch


def jax_backbone_spec(bb: Dict[str, Any]) -> dict:
    """The structure :func:`backbone_rules` walks, read from a JAX
    backbone's params tree."""
    if "stem1" in bb:
        return dict(type="VoVNetCP",
                    blocks=tuple(_count(bb, f"stage{n}_")
                                 for n in range(2, 6)),
                    layers=_count(bb["stage2_0"], "conv"))
    if "stem_conv" in bb:
        n = _count(bb, "down") // 2 + 1
        return dict(type="ConvNeXt",
                    depths=tuple(_count(bb, f"stage{i}_") for i in range(n)),
                    out_indices=tuple(i for i in range(n)
                                      if f"out_norm{i}" in bb))
    if "patch_embed" in bb:
        n = _count(bb, "merge") // 2 + 1
        return dict(type="SwinTransformer",
                    depths=tuple(_count(bb, f"stage{i}_") for i in range(n)),
                    embed=bb["patch_embed"]["kernel"].shape[-1],
                    out_indices=tuple(i for i in range(n)
                                      if f"out_norm{i}" in bb))
    if "base_layer" in bb:
        trees = [_dla_jax_tree(bb[f"level{lvl}"]) for lvl in range(2, 6)]
        return dict(type="DLANet",
                    levels=(1, 1) + tuple(t[0] for t in trees),
                    channels=(bb["level0"]["conv"]["kernel"].shape[-1],
                              bb["level1"]["conv"]["kernel"].shape[-1])
                    + tuple(t[1] for t in trees))
    return dict(type="ResNet",
                blocks=tuple(_count(bb, f"layer{i}_") for i in range(1, 5)),
                convs=3 if "conv3" in bb["layer1_0"] else 2)


def _rules(b, spec: dict) -> None:
    """Every rule of an FB-OCC of structure ``spec`` (:func:`_jax_spec`,
    :func:`_model_spec`)."""
    backbone_rules(b, "img_backbone.", ("img_backbone",), spec["backbone"])
    for i in range(2):
        b.conv(f"img_neck.lateral_convs.{i}.conv", ("img_neck", f"lateral{i}"))
    b.conv("img_neck.fpn_convs.0.conv", ("img_neck", "fpn0"))

    dn, D = "depth_net", ("depth_net",)
    b.convbn(f"{dn}.reduce_conv.0", f"{dn}.reduce_conv.1",
             D + ("reduce_conv",))
    b.bn(f"{dn}.bn", D + ("param_bn",))
    for br in ("context", "depth"):
        b.linear(f"{dn}.{br}_mlp.fc1", D + (f"{br}_mlp", "fc1"))
        b.linear(f"{dn}.{br}_mlp.fc2", D + (f"{br}_mlp", "fc2"))
        for tconv, fdense in (("conv_reduce", "reduce"),
                              ("conv_expand", "expand")):
            b.linear(f"{dn}.{br}_se.{tconv}", D + (f"{br}_se", fdense),
                     conv1x1=True)
    b.conv(f"{dn}.context_conv", D + ("context_conv",))
    for i in range(3):
        p, d = f"{dn}.depth_conv.{i}", D + (f"depth_block{i}",)
        b.convbn(f"{p}.conv1", f"{p}.bn1", d + ("conv1",))
        b.convbn(f"{p}.conv2", f"{p}.bn2", d + ("conv2",))
    aspp, A = f"{dn}.depth_conv.3", D + ("aspp",)
    for i in range(4):
        b.convbn(f"{aspp}.aspp{i + 1}.atrous_conv", f"{aspp}.aspp{i + 1}.bn",
                 A + (f"aspp{i + 1}",))
    b.convbn(f"{aspp}.global_avg_pool.1", f"{aspp}.global_avg_pool.2",
             A + ("gap",))
    b.convbn(f"{aspp}.conv1", f"{aspp}.bn1", A + ("proj",))
    b.conv(f"{dn}.depth_conv.4", D + ("depth_conv",))

    if spec["backward_projection"]:
        _backward_projection_rules(b)

    for src, dst in (("history_keyframe_time_conv", "history_time_conv"),
                     ("history_keyframe_cat_conv", "history_cat_conv")):
        b.conv(f"{src}.0", (dst, "conv"), ndim=3)
        b.bn(f"{src}.1", (dst, "bn"))

    be, E = "img_bev_encoder_backbone", ("img_bev_encoder_backbone",)
    b.convbn(f"{be}.input_proj.0", f"{be}.input_proj.1", E + ("input_proj",),
             ndim=3)
    for stage in range(3):
        for i in range(2):
            p, d = f"{be}.layers.{stage}.{i}", E + (f"layer{stage}_{i}",)
            b.convbn(f"{p}.conv1", f"{p}.bn1", d + ("conv1",), ndim=3)
            b.convbn(f"{p}.conv2", f"{p}.bn2", d + ("conv2",), ndim=3)
            if b._has(d + ("downsample", "conv", "kernel")):
                b.convbn(f"{p}.downsample.0", f"{p}.downsample.1",
                         d + ("downsample",), ndim=3)

    nk, K = "img_bev_encoder_neck", ("img_bev_encoder_neck",)
    for i in range(3):
        for kind, name in (("lateral_convs", "lateral"), ("fpn_convs", "fpn")):
            b.convbn(f"{nk}.{kind}.{i}.0.conv", f"{nk}.{kind}.{i}.0.bn",
                     K + (f"{name}{i}",), ndim=3)

    if spec["occupancy_head"]:
        occ_head_rules(b, "occupancy_head.", ("occupancy_head",))
    if spec["detection_head"]:
        centerpoint_head_rules(b, "pts_bbox_head.", ("pts_bbox_head",),
                               spec["detection_head"])


def _backward_projection_rules(b) -> None:
    bp, P = "backward_projection", ("backward_projection",)
    b.raw(f"{bp}.bev_embedding.weight", P + ("bev_embedding",))
    for e in ("row_embed", "col_embed"):
        b.raw(f"{bp}.positional_encoding.{e}.weight",
              P + ("positional_encoding", e, "embedding"))
    layer = f"{bp}.transformer.encoder.layers.0"
    L = P + ("layer0",)
    for nm in ("sampling_offsets", "attention_weights", "value_proj",
               "output_proj"):
        b.linear(f"{layer}.attentions.0.{nm}", L + ("self_attn", nm))
    for nm in ("sampling_offsets", "attention_weights", "value_proj"):
        b.linear(f"{layer}.attentions.1.deformable_attention.{nm}",
                 L + ("cross_attn", "deformable_attention", nm))
    b.linear(f"{layer}.attentions.1.output_proj",
             L + ("cross_attn", "output_proj"))
    b.linear(f"{layer}.ffns.0.layers.0.0", L + ("ffn", "fc1"))
    b.linear(f"{layer}.ffns.0.layers.1", L + ("ffn", "fc2"))
    for i in range(3):
        b.layernorm(f"{layer}.norms.{i}", L + (f"norm{i + 1}",))


def occ_head_rules(b: _Exporter, src: str, dst: Tuple[str, ...]) -> None:
    """The ``OccHead`` rules: port names prefixed by ``src``, JAX paths
    under ``dst``."""
    b.deconv3d(f"{src}deblock.0", dst + ("deblock_conv",))
    b.bn(f"{src}deblock.1", dst + ("deblock_bn",))
    for i in range(3):
        b.convbn(f"{src}occ_convs.{i}.0", f"{src}occ_convs.{i}.1",
                 dst + (f"occ_conv{i}",), ndim=3)
    b.convbn(f"{src}voxel_soft_weights.0", f"{src}voxel_soft_weights.1",
             dst + ("soft_weight_conv1",), ndim=3)
    b.conv(f"{src}voxel_soft_weights.3", dst + ("soft_weight_conv2",),
           ndim=3)
    b.convbn(f"{src}occ_pred_conv.0", f"{src}occ_pred_conv.1",
             dst + ("pred_conv1",), ndim=3)
    b.conv(f"{src}occ_pred_conv.3", dst + ("pred_conv2",), ndim=3)


def centerpoint_head_rules(b: _Exporter, src: str, dst: Tuple[str, ...],
                           n_tasks: int) -> None:
    """The ``CenterHead`` rules (the reference's mmdet3d names): port names
    prefixed by ``src``, JAX paths under ``dst``, ``n_tasks`` tasks."""
    b.convbn(f"{src}shared_conv.conv", f"{src}shared_conv.bn",
             dst + ("shared_conv",))
    for t in range(n_tasks):
        for name in BRANCHES:
            p, d = f"{src}task_heads.{t}.{name}", dst + (f"task{t}",)
            b.convbn(f"{p}.0.conv", f"{p}.0.bn", d + (f"{name}_conv0",))
            b.conv(f"{p}.1", d + (f"{name}_final",))


def frpn_rules(b: _Exporter, src: str, dst: Tuple[str, ...]) -> None:
    """The ``FRPN`` rules: ``mask_net.{0,1,3}`` from JAX's ``conv1``
    ({conv, bn}) and ``conv2``."""
    b.convbn(f"{src}mask_net.0", f"{src}mask_net.1", dst + ("conv1",))
    b.conv(f"{src}mask_net.3", dst + ("conv2",))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _jax_spec(params: Dict[str, Any]) -> dict:
    """The structure :func:`_rules` walks, read from a JAX params tree."""
    return dict(backbone=jax_backbone_spec(params["img_backbone"]),
                backward_projection="backward_projection" in params,
                occupancy_head="occupancy_head" in params,
                detection_head=sum(1 for k in params.get("pts_bbox_head", {})
                                   if k.startswith("task")))


def _model_spec(model: torch.nn.Module) -> dict:
    """The structure :func:`_rules` walks, read from a port ``FBOCC``."""
    return dict(backbone=backbone_spec(model.img_backbone),
                backward_projection=model.backward_projection is not None,
                occupancy_head=model.occupancy_head is not None,
                detection_head=(0 if model.pts_bbox_head is None
                                else len(model.pts_bbox_head.task_heads)))


def to_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``{'params', 'batch_stats'}`` (nested dicts of arrays) of an
    FBOCC -> the port's state dict (numpy, PyTorch layouts).  Raises if
    any JAX leaf is left unconverted."""
    return module_state_dict(
        variables, lambda b: _rules(b, _jax_spec(variables["params"])))


def module_state_dict(variables: Dict[str, Any],
                      rules: Callable[[_Exporter], None]
                      ) -> Dict[str, np.ndarray]:
    """JAX variables of any module -> the port's state dict by ``rules``
    (e.g. ``lambda b: frpn_rules(b, "", ())`` for a lone ``FRPN``).
    Raises if any JAX leaf is left unconverted."""
    b = _Exporter(variables["params"], variables.get("batch_stats", {}))
    rules(b)
    left = [p for t in ("params", "batch_stats")
            for p in ((t,) + q for q in _leaves(b.trees[t]))
            if p not in b.used]
    if left:
        raise KeyError(f"JAX leaves without a rule: {left[:5]}")
    return b.sd


class _PartialExporter(_Exporter):
    """The rules over a tree that may lack some leaves (a partial warm
    start): a leaf that is absent converts to nothing."""

    def _put(self, name, tree, path, relayout=None):
        d = self.trees[tree]
        for k in path:
            if not isinstance(d, dict) or k not in d:
                return
            d = d[k]
        super()._put(name, tree, path, relayout)


def partial_state_dict(variables: Dict[str, Any], model: torch.nn.Module
                       ) -> Tuple[Dict[str, np.ndarray], int]:
    """JAX ``{'params', 'batch_stats'}`` that may hold only part of
    ``model``'s leaves -> (the port's state dict of the leaves it holds,
    the number of its leaves no rule of ``model``'s structure reads)."""
    b = _PartialExporter(variables.get("params", {}),
                         variables.get("batch_stats", {}))
    _rules(b, _model_spec(model))
    unused = sum(1 for t in ("params", "batch_stats")
                 for q in _leaves(b.trees[t]) if (t,) + q not in b.used)
    return b.sd, unused


def load_jax_variables(model: torch.nn.Module, variables: Dict[str, Any],
                       rules: Optional[Callable[[_Exporter], None]] = None
                       ) -> torch.nn.Module:
    """Load JAX variables into ``model`` with ``strict=True``: an FBOCC's,
    or any module's by ``rules`` (:func:`module_state_dict`).  BatchNorm's
    ``num_batches_tracked`` counters, which JAX does not keep, are 0."""
    sd = (to_state_dict(variables) if rules is None
          else module_state_dict(variables, rules))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    for k in model.state_dict():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros((), dtype=torch.long)
    model.load_state_dict(sd, strict=True)
    return model


class _PairFinder:
    """Runs the rules without weights, recording which port module each
    JAX conv / BatchNorm path maps to."""

    def __init__(self):
        self.convs, self.bns = {}, {}

    def _has(self, path) -> bool:
        return True  # pairs the model lacks are dropped by the caller

    def conv(self, src, dst, ndim=2):
        self.convs[dst] = src

    def bn(self, src, dst):
        self.bns[dst] = src

    def convbn(self, src_conv, src_bn, dst, ndim=2):
        self.conv(src_conv, dst + ("conv",), ndim)
        self.bn(src_bn, dst + ("bn",))

    def deconv3d(self, src, dst, **_):
        pass

    linear = layernorm = raw = deconv3d


def conv_bn_pairs(model: torch.nn.Module) -> List[Tuple[str, str]]:
    """(conv, BatchNorm) module names of ``model`` whose JAX counterparts
    form one ``{conv: {kernel, ...}, bn: ...}`` subtree: those the JAX
    ``fold_batch_norms`` (``fbbev_tpu/utils/fuse_bn.py``) folds.  A conv
    and a BatchNorm that sit side by side in one JAX module under other
    names (the occ head's ``deblock_conv`` / ``deblock_bn``) are no such
    subtree."""
    f = _PairFinder()
    _rules(f, _model_spec(model))
    names = dict(model.named_modules())
    pairs = []
    for dst, conv in f.convs.items():
        if dst[-1] != "conv" or dst[:-1] + ("bn",) not in f.bns:
            continue
        bn = f.bns[dst[:-1] + ("bn",)]
        if conv in names and bn in names:
            pairs.append((conv, bn))
    return pairs


def conv_paths(model: torch.nn.Module) -> Dict[str, str]:
    """{port conv module name: its JAX module path} of an FBOCC, e.g.
    ``depth_net.depth_conv.4`` -> ``depth_net/depth_conv`` and
    ``depth_net.depth_conv.3.aspp1.atrous_conv`` ->
    ``depth_net/aspp/aspp1/conv``: the JAX package's regexes over module
    paths (the int8 exclusions) read the JAX path.  From the same rules as
    the weights; convs that no rule names are absent."""
    f = _PairFinder()
    _rules(f, _model_spec(model))
    names = dict(model.named_modules())
    return {src: "/".join(dst) for dst, src in f.convs.items()
            if src in names}
