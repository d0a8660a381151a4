"""Model builder from a config's ``model`` dict.  Counterpart of
``fbbev_tpu/models/builder.py``.

A config gives the model in one of two schemas: flat ``FBOCC`` keyword
arguments (``fbbev_tpu_torch/configs/fbocc-r50-cbgs_depth_16f.py``), or
the reference's nested component dicts (``model = dict(type='FBOCC',
img_backbone=dict(type='ResNet', ...), depth_net=dict(...), ...)``,
``fbocc-r50-cbgs_depth_16f_nested.py``), which
:func:`translate_reference_model_cfg` turns into the flat one.
:func:`build_detector` takes either.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

# the reference's backbone types (the JAX package's); other names raise
BACKBONE_TYPES = ("ResNet", "VoVNetCP", "ConvNeXt", "SwinTransformer",
                  "DLANet")


def translate_reference_model_cfg(model: Dict[str, Any]) -> Dict[str, Any]:
    """Nested reference-style model dict -> FBOCC kwargs."""
    m = dict(model)
    m.pop("type", None)
    kwargs: Dict[str, Any] = {}

    bb = m.pop("img_backbone", None)
    if bb:
        btype = bb.get("type", "ResNet")
        if btype not in BACKBONE_TYPES:
            raise KeyError(btype)
        kwargs["backbone_type"] = btype
        if btype == "ResNet":
            kwargs["backbone_depth"] = bb.get("depth", 50)
        elif "spec_name" in bb:
            kwargs["backbone_arch"] = bb["spec_name"]
        elif "arch" in bb:
            kwargs["backbone_arch"] = bb["arch"]
        if bb.get("with_cp"):
            kwargs["remat"] = True

    neck = m.pop("img_neck", None)
    if neck:
        kwargs["img_feat_channels"] = neck.get("out_channels", 256)

    dn = m.pop("depth_net", None)
    if dn:
        kwargs["single_bev_num_channels"] = dn.get("context_channels", 80)
        kwargs["depth_channels"] = dn.get("depth_channels", 80)
        if dn.get("grid_config"):
            kwargs["grid_config"] = {
                k: tuple(v) for k, v in dn["grid_config"].items()}

    fp = m.pop("forward_projection", None)
    if fp:
        if fp.get("grid_config"):
            kwargs["grid_config"] = {
                k: tuple(v) for k, v in fp["grid_config"].items()}
        if fp.get("input_size"):
            kwargs["input_size"] = tuple(fp["input_size"])
        kwargs["downsample"] = fp.get("downsample", 16)

    bp = m.pop("backward_projection", None)
    kwargs["use_backward_projection"] = bp is not None
    if bp:
        if bp.get("pc_range"):
            kwargs["pc_range"] = tuple(bp["pc_range"])
        tf = bp.get("transformer", {})
        enc = tf.get("encoder", {})
        if enc.get("grid_config"):
            kwargs["bevformer_grid_config"] = {
                k: tuple(v) for k, v in enc["grid_config"].items()}

    bev_bb = m.pop("img_bev_encoder_backbone", None)
    if bev_bb:
        kwargs["voxel_channels"] = tuple(
            bev_bb.get("block_inplanes", (64, 128, 256)))
    bev_neck = m.pop("img_bev_encoder_neck", None)
    if bev_neck:
        kwargs["voxel_out_channels"] = bev_neck.get("out_channels", 256)

    occ = m.pop("occupancy_head", None)
    kwargs["use_occupancy_head"] = occ is not None
    if occ:
        kwargs["num_classes"] = occ.get("out_channel", 19)

    pts = m.pop("pts_bbox_head", None)
    kwargs["use_detection_head"] = pts is not None

    m.pop("frpn", None)  # FRPN is config-disabled in all shipped models

    # passthrough scalar options shared with the flat schema
    for key in ("use_depth_supervision", "do_history", "history_cat_num",
                "history_cat_conv_out_channels", "readd",
                "single_bev_num_channels", "fix_void", "dtype",
                "max_queries_per_cam", "num_cams"):
        if key in m:
            val = m.pop(key)
            if key in ("do_history", "fix_void"):
                continue  # runtime/loss concerns, not constructor kwargs
            kwargs[key] = val
    return kwargs


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def detector_kwargs(model_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The ``FBOCC`` arguments of a model config of either schema, dtype
    strings as torch dtypes, sequences as tuples.  Of the JAX model's
    keys, ``use_tiled_warp`` (its fused eval warp) becomes ``fuse_warp``;
    ``readd`` (which JAX's forward never reads) and ``backbone_arch`` (the
    M12 backbones') are dropped."""
    cfg = dict(model_cfg)
    cfg.pop("type", None)
    nested = any(isinstance(v, dict) and "type" in v for v in cfg.values())
    kwargs = translate_reference_model_cfg(cfg) if nested else cfg
    kwargs.pop("readd", None)
    kwargs.pop("backbone_arch", None)
    if "use_tiled_warp" in kwargs:
        kwargs["fuse_warp"] = kwargs.pop("use_tiled_warp")
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = DTYPES[kwargs["dtype"]]
    for key in ("input_size", "voxel_channels", "pc_range"):
        if key in kwargs and kwargs[key] is not None:
            kwargs[key] = tuple(kwargs[key])
    for key in ("grid_config", "bevformer_grid_config"):
        if key in kwargs and kwargs[key] is not None:
            kwargs[key] = {k: tuple(v) for k, v in kwargs[key].items()}
    return kwargs


def build_detector(model_cfg: Dict[str, Any], device="cuda",
                   generator: Optional[torch.Generator] = None, **routes):
    """An ``FBOCC`` from a model config of either schema, on ``device``,
    its random weights from ``generator``.  ``routes`` are further
    ``FBOCC`` arguments that no config sets -- the kernel routes
    (``fuse_warp``, ``occ_tail``, ``pallas_conv3d``, ...), which the JAX
    package takes from environment variables -- or overrides (``dtype``)."""
    from fbbev_tpu_torch.models.fbocc import FBOCC  # noqa: F401 (registers)
    from fbbev_tpu_torch.registry import DETECTORS, build_from_cfg
    kwargs = dict(detector_kwargs(model_cfg), **routes)
    return build_from_cfg(dict(kwargs, type=model_cfg.get("type", "FBOCC")),
                          DETECTORS, device=device, generator=generator)
