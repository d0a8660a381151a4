"""JAX variables -> the port's state dict.

The port's module names are the reference's torch names, so moving
weights from the JAX package is a relayout: its ``params`` /
``batch_stats`` trees (nested dicts of numpy arrays) become a flat state
dict in PyTorch layouts, loaded with ``load_state_dict(strict=True)``.
The rules are this package's own copy of the flagship FB-OCC rules of
``fbbev_tpu/train/checkpoint_convert.py`` (export direction):

* conv kernel (kh, kw, I, O) / (kd, kh, kw, I, O) -> (O, I, k...)
* transposed-conv kernel (kd, kh, kw, I, O), stored unflipped for
  ``lax.conv_transpose`` -> torch ``ConvTranspose3d`` (I, O, kd, kh, kw)
  with the spatial flip torch's deconvolution semantics need
* dense (I, O) -> linear (O, I); a dense standing for a 1x1 conv gets
  trailing (1, 1)
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


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

    def linear(self, src, dst, conv1x1=False):
        self._put(src + ".weight", "params", dst + ("kernel",),
                  lambda k: k.T[:, :, None, None] if conv1x1 else k.T)
        if self._has(dst + ("bias",)):
            self._put(src + ".bias", "params", dst + ("bias",))

    def layernorm(self, src, dst):
        self._put(src + ".weight", "params", dst + ("scale",))
        self._put(src + ".bias", "params", dst + ("bias",))

    def raw(self, src, dst):
        self._put(src, "params", dst)

    def convbn(self, src_conv, src_bn, dst, ndim=2):
        self.conv(src_conv, dst + ("conv",), ndim)
        self.bn(src_bn, dst + ("bn",))


def _resnet(b, src: str, dst: str, spec: dict):
    """ResNet stages: ``spec['blocks']`` blocks per stage, each of
    ``spec['convs']`` convs (3 for bottlenecks, 2 for basic blocks)."""
    b.convbn(f"{src}.conv1", f"{src}.bn1", (dst, "stem"))
    for stage, n in enumerate(spec["blocks"]):
        for i in range(n):
            p = f"{src}.layer{stage + 1}.{i}"
            d = (dst, f"layer{stage + 1}_{i}")
            for c in range(1, spec["convs"] + 1):
                b.convbn(f"{p}.conv{c}", f"{p}.bn{c}", d + (f"conv{c}",))
            if b._has(d + ("downsample", "conv", "kernel")):
                b.convbn(f"{p}.downsample.0", f"{p}.downsample.1",
                         d + ("downsample",))


def _rules(b, spec: dict) -> None:
    """Every rule of an FB-OCC of structure ``spec`` (:func:`_jax_spec`,
    :func:`_model_spec`)."""
    _resnet(b, "img_backbone", "img_backbone", spec)
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


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _jax_spec(params: Dict[str, Any]) -> dict:
    """The structure :func:`_rules` walks, read from a JAX params tree."""
    bb = params["img_backbone"]
    blocks = tuple(sum(1 for k in bb if k.startswith(f"layer{i}_"))
                   for i in range(1, 5))
    return dict(blocks=blocks, convs=3 if "conv3" in bb["layer1_0"] else 2,
                backward_projection="backward_projection" in params,
                occupancy_head="occupancy_head" in params)


def _model_spec(model: torch.nn.Module) -> dict:
    """The structure :func:`_rules` walks, read from a port ``FBOCC``."""
    bb = model.img_backbone
    return dict(blocks=tuple(len(getattr(bb, f"layer{i}"))
                             for i in range(1, 5)),
                convs=3 if hasattr(bb.layer1[0], "conv3") else 2,
                backward_projection=model.backward_projection is not None,
                occupancy_head=model.occupancy_head is not None)


def to_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``{'params', 'batch_stats'}`` (nested dicts of arrays) -> the
    port's state dict (numpy, PyTorch layouts).  Raises if any JAX leaf
    is left unconverted."""
    b = _Exporter(variables["params"], variables.get("batch_stats", {}))
    _rules(b, _jax_spec(variables["params"]))
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


def load_jax_variables(model: torch.nn.Module,
                       variables: Dict[str, Any]) -> torch.nn.Module:
    """Load JAX variables into ``model`` with ``strict=True``; BatchNorm's
    ``num_batches_tracked`` counters, which JAX does not keep, are 0."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in to_state_dict(variables).items()}
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
