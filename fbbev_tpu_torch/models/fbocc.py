"""FB-OCC / FB-BEV: image encoder, depth net, forward (LSS) and backward
projection, SoloFusion temporal fusion, 3D encoder, occupancy head and
CenterPoint detection head.  Counterpart of ``fbbev_tpu/models/fbocc.py``.

The temporal history is an explicit :class:`TemporalState` carried from
frame to frame, in one of two layouts (as in the JAX package):

* evaluation with ``fuse_warp`` on (the default), in serving
  (``serving.py``) and in :meth:`FBOCC.forward` alike, keeps it in FIXED
  ring slots (:meth:`FBOCC.fuse_history`), the layout of the JAX
  package's fused TPU path (``fbocc.py:357-419``) and K1's contract: each
  frame overwrites its oldest slot and ``sweep_time`` carries each slot's
  age; age order is restored where it is consumed, by permuting the rows
  of the cat-conv weight;
* training, and evaluation with ``fuse_warp=False``, keep it age-ordered
  (newest first, shifted by one frame per step), the JAX package's
  fallback (``fbocc.py:436-513``, :meth:`FBOCC.fuse_history_aged`), whose
  eval warp is K5.  An age-ordered state is also a ring-slot one (each
  slot's age is in ``sweep_time``), so evaluation may continue a state
  that training left, as in JAX; the converse does not hold.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from fbbev_tpu_torch import geometry, parallel
from fbbev_tpu_torch.models import convnext, dla, resnet, swin, vovnet
from fbbev_tpu_torch.models.bevformer import BackwardProjection
from fbbev_tpu_torch.models.centerpoint_head import CenterHead, SeparateHead
from fbbev_tpu_torch.models.depth_net import CM_DepthNet, get_mlp_input
from fbbev_tpu_torch.models.fpn import CustomFPN
from fbbev_tpu_torch.models.fpn3d import FPN3D
from fbbev_tpu_torch.models.layers import (BatchNorm, RingCatConvBN,
                                           TimeEmbedConvBN,
                                           cast_with_islands)
from fbbev_tpu_torch.models.lss import LSSViewTransformer3D
from fbbev_tpu_torch.models.occ_head import OccHead
from fbbev_tpu_torch.models.resnet3d import CustomResNet3D
from fbbev_tpu_torch.ops import pallas_fuse_warp, pallas_warp
from fbbev_tpu_torch.registry import DETECTORS

DEFAULT_GRID_CONFIG = {
    "x": (-40.0, 40.0, 0.8),
    "y": (-40.0, 40.0, 0.8),
    "z": (-1.0, 5.4, 0.8),
    "depth": (2.0, 42.0, 0.5),
}

# the BEV Y rows of the 3D encoder's coarsest level: its strides 1, 2, 2
BEV_ROW_STRIDE = 4

DEFAULT_BEVFORMER_GRID = {
    "x": (-40.0, 40.0, 0.8),
    "y": (-40.0, 40.0, 0.8),
    "z": (-1.0, 5.4, 1.6),
}


class TemporalState(NamedTuple):
    """SoloFusion history ring buffer."""

    history_bev: torch.Tensor    # (B, Z, Y, X, T*C), ring-slot channels
    sweep_time: torch.Tensor     # (B, T) frames-ago of each slot
    seq_ids: torch.Tensor        # (B,) scene-stream ids
    forward_augs: torch.Tensor   # (B, 4, 4) BDA of the buffered frames


def init_temporal_state(batch: int, grid_size: Tuple[int, int, int],
                        history_cat_num: int = 16, channels: int = 80,
                        dtype=torch.float32,
                        device="cuda") -> TemporalState:
    """Empty history; ``dtype`` should be the model's compute dtype."""
    nx, ny, nz = grid_size
    return TemporalState(
        history_bev=torch.zeros(batch, nz, ny, nx, history_cat_num * channels,
                                dtype=dtype, device=device),
        sweep_time=torch.zeros(batch, history_cat_num, device=device),
        seq_ids=torch.full((batch,), -1, dtype=torch.int32, device=device),
        forward_augs=torch.eye(4, device=device).repeat(batch, 1, 1))


def build_backbone(backbone_type: str, depth: int, arch: str,
                   pallas3x3: bool = False, remat: bool = False):
    """(image backbone, the neck's input channels) of an FBOCC config, as
    JAX ``fbocc.py:190-227``: the outputs at strides 16 and 32 -- ResNet's
    C4 / C5, VoVNet's stages 4 / 5, ConvNeXt's and Swin's stages 2 / 3,
    DLA's levels 4 / 5.  ``pallas3x3`` reaches the backbones with 3x3
    stride-1 convs, ``remat`` ResNet and VoVNet only."""
    if backbone_type == "ResNet":
        return (resnet.ResNet(pallas3x3, remat, depth),
                resnet.out_channels(depth))
    if backbone_type == "VoVNetCP":
        ch = vovnet.STAGE_SPECS[arch]["stage_out_ch"]
        return (vovnet.VoVNetCP(arch, (2, 3), pallas3x3, remat),
                (ch[2], ch[3]))
    if backbone_type == "ConvNeXt":
        dims = convnext.SPECS[arch]["dims"]
        return convnext.ConvNeXt(arch, (2, 3)), (dims[2], dims[3])
    if backbone_type == "SwinTransformer":
        e = swin.SPECS[arch]["embed"]
        return swin.SwinTransformer(arch, out_indices=(2, 3)), (4 * e, 8 * e)
    if backbone_type == "DLANet":
        ch = dla.SPECS[arch]["channels"]
        return dla.DLANet(arch, (4, 5), pallas3x3), (ch[4], ch[5])
    raise KeyError(backbone_type)


def make_backward_projection(model: "FBOCC") -> BackwardProjection:
    """The BackwardProjection head of an FBOCC config."""
    fp = model.forward_projection
    C = model.single_bev_num_channels
    return BackwardProjection(
        bev_h=int(fp.nx[1]), bev_w=int(fp.nx[0]), embed_dims=C,
        feedforward_channels=4 * C, pos_num_feats=C // 2,
        grid_config=model.bevformer_grid_config,
        input_size=model.input_size,
        dbound=tuple(model.grid_config["depth"]),
        max_queries_per_cam=model.max_queries_per_cam,
        pc_range=model.pc_range)


@DETECTORS.register
class FBOCC(nn.Module):
    """Flagship FB-OCC (R50, 16 history frames, occupancy head); the
    defaults are ``fbbev_tpu/configs/fbocc-r50-cbgs_depth_16f.py``.  The
    config arguments are those of the JAX ``FBOCC`` (``fbocc.py:151-174``),
    stored as attributes of the same names:

    * ``backbone_type`` ``"ResNet"`` of ``backbone_depth`` 10, 18, 34, 50
      or 101, or ``"VoVNetCP"``, ``"ConvNeXt"``, ``"SwinTransformer"`` or
      ``"DLANet"`` of ``backbone_arch`` (a ``STAGE_SPECS`` / ``SPECS`` key
      of its module: ``"V-99-eSE"`` is the large variant's), with the neck
      inputs of JAX ``fbocc.py:190-227`` (:func:`build_backbone`);
    * ``use_backward_projection`` off: no BEVFormer head, the LSS voxels
      go straight to the history fusion; ``use_occupancy_head`` off: no
      head and no ``occ_logits``; ``use_detection_head`` on (FB-BEV,
      ``fbbev-r50-det_16f.py``): the CenterPoint head
      (``pts_bbox_head``) on the finest 3D-encoder level with Z folded
      into channels, ``det_preds`` among the outputs;
    * ``pc_range`` reaches the backward projection (its anchors span it
      when it has no grid of its own);
    * ``use_depth_supervision`` is the ``Trainer``'s default.  The JAX
      config keys ``readd`` and ``use_tiled_warp`` are taken by
      :func:`~fbbev_tpu_torch.models.builder.detector_kwargs`: JAX's
      forward never reads ``readd``, and ``use_tiled_warp`` is
      ``fuse_warp`` here.

    ``pallas3x3`` routes the 3x3 stride-1 convolutions to K7 as the JAX
    configuration ``FBBEV_PALLAS3X3=1`` does (default off, as there): the
    image trunk's 2D ones directly, the 3D encoder's, FPN3D's and the occ
    head's 3x3x3 ones through the z-slab decomposition;
    ``remat`` checkpoints each ResNet stage or VoVNet OSA block in training
    (the config's ``remat=True``; the JAX package remats those two
    backbones only).

    The JAX package's opt-in eval routes, each named after its switch and
    taken exactly where the JAX gate holds (train mode is unchanged):
    ``fuse_warp`` (``FBBEV_FUSE_WARP``, default on) serves through
    :meth:`fuse_history` on K1; off, :meth:`fuse_history_aged` warps the
    age-ordered history on K5.  ``pallas_conv3d`` (``FBBEV_CONV3D=pallas``)
    sends the stride-1 3x3x3 convs to K6.  ``coarse_pred``
    (``FBBEV_OCC_COARSE_PRED``, default on), ``occ_tail``
    (``FBBEV_OCC_TAIL``: K8) and ``occ_fuse`` (``FBBEV_OCCFUSE``: K9)
    pick the occ head's tail (:class:`OccHead`)."""

    def __init__(self, grid_config=None, bevformer_grid_config=None,
                 input_size: Tuple[int, int] = (256, 704),
                 downsample: int = 16, num_cams: int = 6,
                 backbone_type: str = "ResNet", backbone_depth: int = 50,
                 backbone_arch: str = "V-99-eSE",
                 img_feat_channels: int = 256,
                 single_bev_num_channels: int = 80, depth_channels: int = 80,
                 depth_mid_channels: int = 512, history_cat_num: int = 16,
                 history_cat_conv_out_channels: int = 160,
                 num_classes: int = 19,
                 use_backward_projection: bool = True,
                 use_depth_supervision: bool = True,
                 use_occupancy_head: bool = True,
                 max_queries_per_cam: Optional[int] = 4096,
                 use_detection_head: bool = False,
                 voxel_channels: Tuple[int, ...] = (64, 128, 256),
                 voxel_out_channels: int = 256,
                 pc_range: Tuple[float, ...] = (-40, -40, -1.0, 40, 40, 5.4),
                 dtype=torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 pallas3x3: bool = False, remat: bool = False,
                 occ_tail: bool = False, occ_fuse: bool = False,
                 coarse_pred: bool = True, pallas_conv3d: bool = False,
                 fuse_warp: bool = True):
        super().__init__()
        self.grid_config = dict(grid_config or DEFAULT_GRID_CONFIG)
        self.bevformer_grid_config = dict(
            bevformer_grid_config or DEFAULT_BEVFORMER_GRID)
        self.input_size = tuple(input_size)
        self.downsample = downsample
        self.num_cams = num_cams
        self.backbone_type = backbone_type
        self.backbone_depth = backbone_depth
        self.backbone_arch = backbone_arch
        self.img_feat_channels = img_feat_channels
        self.single_bev_num_channels = C = single_bev_num_channels
        self.depth_channels = depth_channels
        self.depth_mid_channels = depth_mid_channels
        self.history_cat_num = history_cat_num
        self.history_cat_conv_out_channels = history_cat_conv_out_channels
        self.num_classes = num_classes
        self.use_backward_projection = use_backward_projection
        self.use_depth_supervision = use_depth_supervision
        self.use_occupancy_head = use_occupancy_head
        self.max_queries_per_cam = max_queries_per_cam
        self.use_detection_head = use_detection_head
        self.voxel_channels = tuple(voxel_channels)
        self.voxel_out_channels = voxel_out_channels
        self.pc_range = tuple(pc_range)
        self.remat = remat
        self.pallas3x3 = pallas3x3
        self.fuse_warp = fuse_warp
        self.forward_projection = LSSViewTransformer3D(
            self.grid_config, self.input_size, downsample)

        self.img_backbone, neck_in = build_backbone(
            backbone_type, backbone_depth, backbone_arch, pallas3x3, remat)
        self.img_neck = CustomFPN(neck_in, img_feat_channels, pallas3x3)
        self.depth_net = CM_DepthNet(img_feat_channels, depth_mid_channels,
                                     C, depth_channels, pallas3x3)
        self.backward_projection = (make_backward_projection(self)
                                    if use_backward_projection else None)
        self.history_keyframe_time_conv = TimeEmbedConvBN(C, C)
        self.history_keyframe_cat_conv = RingCatConvBN(
            C * (history_cat_num + 1), history_cat_conv_out_channels)
        self.img_bev_encoder_backbone = CustomResNet3D(
            history_cat_conv_out_channels, self.voxel_channels, pallas3x3,
            pallas_conv3d)
        self.img_bev_encoder_neck = FPN3D(self.voxel_channels,
                                          voxel_out_channels, pallas3x3,
                                          pallas_conv3d)
        self.occupancy_head = (OccHead(
            (voxel_out_channels,) * 3, num_classes, pallas3x3,
            pallas_conv3d=pallas_conv3d, coarse_pred=coarse_pred,
            occ_tail=occ_tail, occ_fuse=occ_fuse)
            if use_occupancy_head else None)
        # the head sees the finest 3D level with Z folded into channels
        self.pts_bbox_head = (CenterHead(
            voxel_out_channels * self.forward_projection.grid_size[2],
            pallas3x3=pallas3x3) if use_detection_head else None)
        # the per-camera stage: under a mesh its BatchNorms take the
        # statistics of every rank's cameras (``layers.batch_norm``)
        for stage in (self.img_backbone, self.img_neck, self.depth_net):
            for m in stage.modules():
                if isinstance(m, BatchNorm):
                    m.camera_split = True
        # the BEV stages: under a mesh with a 'space' axis they compute
        # this rank's Y rows (``layers`` module docstring)
        for stage in (self.history_keyframe_time_conv,
                      self.history_keyframe_cat_conv,
                      self.img_bev_encoder_backbone,
                      self.img_bev_encoder_neck, self.occupancy_head):
            for m in stage.modules() if stage is not None else ():
                if hasattr(m, "row_split"):
                    m.row_split = True
        init_weights(self, generator)
        self.to(device=device)
        self.cast(dtype)
        self.eval()

    def cast(self, dtype: torch.dtype) -> "FBOCC":
        """Computes in ``dtype`` from now on, with the float32 islands the
        modules declare (``layers.cast_with_islands``)."""
        self.dtype = dtype
        cast_with_islands(self, dtype)
        return self

    # ------------------------------------------------------------------
    def image_encoder(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) -> (B, N, fH, fW, C) single-level features."""
        B, N, H, W, _ = imgs.shape
        x = imgs.reshape(B * N, H, W, 3).permute(0, 3, 1, 2).to(self.dtype)
        if self.pallas3x3:
            # K7 reads channels-last memory: keep the trunk in it
            x = x.contiguous(memory_format=torch.channels_last)
        # a ConvNeXt's or Swin's outputs are float32 (LayerNorm-ed), cast
        # to the model's type as JAX's neck convs cast their inputs
        x = self.img_neck([f.to(self.dtype) for f in self.img_backbone(x)])
        return x.permute(0, 2, 3, 1).reshape(B, N, *x.shape[2:], x.shape[1])

    def bev_split(self) -> Optional[parallel.RowSplit]:
        """The active mesh's split of the BEV Y rows over 'space' (None:
        none), nested in the 3D encoder's coarsest level."""
        axis = parallel.row_axis()
        if axis is None:
            return None
        ny = self.forward_projection.grid_size[1]
        if ny % BEV_ROW_STRIDE:
            raise ValueError(f"a BEV of {ny} rows has no nested row split")
        return parallel.RowSplit(axis, ny // BEV_ROW_STRIDE)

    # ------------------------------------------------------------------
    def fuse_history(self, curr_bev: torch.Tensor, state: TemporalState,
                     meta: dict, bda: torch.Tensor, do_history: bool = True):
        """SoloFusion temporal fusion on the ring-slot history (eval) on
        K1, the JAX package's fused path (``fbocc.py:350-421``).

        curr_bev: (B, Y, X, Z, C); meta: ``start_of_sequence`` (B,) bool,
        ``sequence_group_idx`` (B,) int, ``curr_to_prev_ego_rt`` (B, 4, 4);
        bda (B, 3, 3); ``do_history`` as :meth:`fuse_history_aged`.
        Returns (fused (B, Y, X, Z, F), new_state, seq_mismatch (B,)).
        Under a row split (:meth:`bev_split`) curr_bev and fused are this
        rank's rows: K1 runs on the gathered grid."""
        dt = self.dtype
        split = self.bev_split()
        if split is not None:
            curr_bev = split.gather(curr_bev, 1)
        curr_bev = curr_bev.to(dt)
        B, C = curr_bev.shape[0], curr_bev.shape[-1]
        T = self.history_cat_num
        dev = curr_bev.device
        start = meta["start_of_sequence"].to(torch.bool)
        if not do_history:
            start = torch.ones_like(start)
        start = start | (state.seq_ids < 0)
        seq_ids = meta["sequence_group_idx"].to(torch.int32)
        forward_augs = geometry.forward_aug_matrix(bda.float())
        curr_to_prev = meta["curr_to_prev_ego_rt"].float()
        seq_mismatch = ~start & (state.seq_ids != seq_ids)

        sweep_r = torch.where(start[:, None], torch.zeros_like(
            state.sweep_time), state.sweep_time + 1.0)
        hist_augs = torch.where(start[:, None, None], forward_augs,
                                state.forward_augs)
        fp = self.forward_projection
        f2b = torch.from_numpy(geometry.feat2bev_matrix(fp.dx, fp.bx)).to(dev)
        mat = geometry.flow_matrix_from_grid_args(hist_augs, forward_augs,
                                                  curr_to_prev, f2b)
        # start samples: every slot becomes the unwarped curr, under the
        # identity flow (the dataset contract on sequence starts)
        eye = torch.eye(4, device=dev).expand(B, 4, 4)
        mat = torch.where(start[:, None, None], eye, mat)
        hsel = torch.argmax(sweep_r, dim=1)                  # oldest slot
        new_sweep = torch.where(
            torch.arange(T, device=dev)[None] == hsel[:, None],
            torch.zeros_like(sweep_r), sweep_r)
        # cat-conv weight rows permuted from ring-slot order to age order
        ranks = torch.argsort(torch.argsort(sweep_r, dim=1, stable=True),
                              dim=1, stable=True)
        slot_rows = ((ranks + 1)[:, :, None] * C
                     + torch.arange(C, device=dev)).reshape(B, T * C)
        curr_rows = torch.arange(C, device=dev)[None].expand(B, C)

        tconv = self.history_keyframe_time_conv
        y1_c = tconv(curr_bev, torch.zeros((), device=dev))
        # eval BN folded into the time conv for the K1 epilogue
        kf = tconv.kernel().float()
        tbn = tconv[1]
        s = tbn.weight.float() * torch.rsqrt(tbn.running_var.float()
                                             + tbn.eps)
        epi = dict(kc=kf[:C] * s[None], ke=kf[C] * s,
                   kb=(tconv[0].bias.float() * s + tbn.bias.float()
                       - tbn.running_mean.float() * s),
                   tvec=sweep_r * 0.5,
                   ws=self.history_keyframe_cat_conv.kernel()[slot_rows])
        part, new_hist = pallas_fuse_warp.fuse_warp(
            state.history_bev.to(dt), curr_bev, mat, start, hsel,
            epilogue=epi)
        fused = self.history_keyframe_cat_conv(part, y1_c, curr_rows)
        if split is not None:
            fused = split.take(fused, 1)
        new_state = TemporalState(history_bev=new_hist, sweep_time=new_sweep,
                                  seq_ids=seq_ids,
                                  forward_augs=forward_augs)
        return fused, new_state, seq_mismatch

    # ------------------------------------------------------------------
    def fuse_history_aged(self, curr_bev: torch.Tensor, state: TemporalState,
                          meta: Dict[str, Any], bda: torch.Tensor,
                          do_history: bool = True):
        """SoloFusion temporal fusion on the age-ordered history, the JAX
        package's fallback (``fbocc.py:436-513``), in train and eval (with
        ``fuse_warp`` off); the warp is K5 in eval, its plain version in
        training.

        curr_bev (B, Y, X, Z, C); meta as :meth:`fuse_history`; with
        ``do_history`` False every sample starts a fresh stream
        (``fbocc.py:314-321``).  Returns (fused (B, Y, X, Z, F),
        new_state, seq_mismatch (B,) bool: a non-start sample whose
        stream id differs from the buffered one).  The history carries no
        gradient.  Under a row split (:meth:`bev_split`) curr_bev and fused
        are this rank's rows: the history is warped whole and stays whole
        on every rank (built from the gathered current BEV), the time and
        cat convs run on the rank's rows."""
        dt = self.dtype
        curr_bev = curr_bev.to(dt)
        split = self.bev_split()
        curr_all = (curr_bev.detach() if split is None
                    else split.gather(curr_bev.detach(), 1))
        B, ny, nx, nz, C = curr_bev.shape
        T = self.history_cat_num
        dev = curr_bev.device
        start = meta["start_of_sequence"].to(torch.bool)
        if not do_history:
            start = torch.ones_like(start)
        start = start | (state.seq_ids < 0)
        seq_ids = meta["sequence_group_idx"].to(torch.int32)
        forward_augs = geometry.forward_aug_matrix(bda.float())
        curr_to_prev = meta["curr_to_prev_ego_rt"].float()
        seq_mismatch = ~start & (state.seq_ids != seq_ids)

        sweep_r = torch.where(start[:, None], torch.zeros_like(
            state.sweep_time), state.sweep_time + 1.0)
        hist_augs = torch.where(start[:, None, None], forward_augs,
                                state.forward_augs)
        with torch.no_grad():
            curr_zyx = curr_all.permute(0, 3, 1, 2, 4)
            hist_zyx = torch.where(start[:, None, None, None, None],
                                   curr_zyx.repeat(1, 1, 1, 1, T),
                                   state.history_bev.to(dt))
            fp = self.forward_projection
            f2b = torch.from_numpy(geometry.feat2bev_matrix(fp.dx, fp.bx)).to(
                dev)
            mat = geometry.flow_matrix_from_grid_args(
                hist_augs, forward_augs, curr_to_prev, f2b)
            # eval: K5 where its gate holds, as the JAX package's
            # fallback (fbocc.py:445-453), else its plain version with the
            # weights rounded as JAX's eval warps round them
            if self.training:
                sampled = pallas_warp.warp_affine_3d_plain(hist_zyx, mat)
            elif pallas_warp.supports(hist_zyx.shape):
                sampled = pallas_warp.warp_affine_3d(hist_zyx, mat)
            else:
                sampled = pallas_warp.warp_affine_3d_plain(
                    hist_zyx, mat, round_weights=True)
            sampled = sampled.to(dt)                       # (B, Y, X, Z, TC)
            new_hist = torch.cat([curr_all, sampled[..., :(T - 1) * C]],
                                 -1).permute(0, 3, 1, 2, 4).contiguous()
        if split is not None:
            sampled = split.take(sampled, 1)
        feats_cat = torch.cat([curr_bev, sampled], -1)     # (1 + T) C
        sweep_full = torch.cat([torch.zeros(B, 1, device=dev), sweep_r], 1)
        # the 1x1x1 time conv mixes no positions: frames fold into Z
        frames = feats_cat.reshape(B, ny, nx, nz * (T + 1), C)
        t_emb = (sweep_full * 0.5)[:, None, :].expand(B, nz, T + 1).reshape(
            B, 1, 1, nz * (T + 1), 1)
        frames = self.history_keyframe_time_conv(frames, t_emb)
        fused = self.history_keyframe_cat_conv.aged(
            frames.reshape(B, ny, nx, nz, (T + 1) * C))
        new_state = TemporalState(history_bev=new_hist,
                                  sweep_time=sweep_full[:, :-1],
                                  seq_ids=seq_ids, forward_augs=forward_augs)
        return fused, new_state, seq_mismatch

    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], state: TemporalState,
                train: bool = False, do_history: bool = True):
        """One frame through the whole model, counterpart of the JAX
        ``FBOCC.__call__`` (``fbocc.py:516-575``).  Sets the module's mode
        from ``train``.  The history fusion is :meth:`fuse_history` (K1)
        in eval with ``fuse_warp`` on, as the JAX forward's fused path,
        else :meth:`fuse_history_aged`; the voxel pool is the segment sum
        of ``ops/bev_pool.py`` (K2 needs the rig's plan: serving).

        ``batch``: imgs (B, N, H, W, 3); the camera parameters (rots,
        trans, intrins, post_rots, post_trans, bda); start_of_sequence,
        sequence_group_idx, curr_to_prev_ego_rt.  Returns (outputs, new
        state); outputs hold ``depth``, ``context``, ``bev_refined`` (with
        the backward projection), ``seq_mismatch`` and ``occ_logits`` (B,
        Y, X, Z, classes) f32 (with the occupancy head) and ``det_preds``
        (with the detection head: per task a dict of (B, Y, X, ch) f32
        maps, as :class:`CenterHead` returns).

        Under an active mesh with a 'space' axis (:meth:`bev_split`) the
        BEV stages compute this rank's Y rows (``parallel`` module
        docstring); ``occ_logits`` are gathered whole on every rank and
        the detection head runs on the gathered finest level."""
        self.train(train)
        cam = geometry.CamParams(*(batch[k] for k in geometry.CamParams._fields))
        feats = self.image_encoder(batch["imgs"])
        context, depth = self.depth_net(feats, get_mlp_input(cam))
        bev = self.forward_projection(cam, context, depth)
        outputs = {"depth": depth, "context": context}
        # under a row split the pool and the backward projection (whose
        # self-attention reads the whole grid) run replicated; the rest
        # computes this rank's rows, from the readd on
        split = self.bev_split()
        if self.backward_projection is not None:
            refined = self.backward_projection(
                context, bev.mean(dim=3).to(self.dtype), depth, cam=cam)
            outputs["bev_refined"] = refined
            if split is not None:
                refined, bev = split.take(refined, 1), split.take(bev, 1)
            bev = refined.float()[:, :, :, None, :] + bev
        elif split is not None:
            bev = split.take(bev, 1)
        fuse = (self.fuse_history_aged if train or not self.fuse_warp
                else self.fuse_history)
        fused, new_state, seq_mismatch = fuse(bev, state, batch, cam.bda,
                                              do_history)
        outputs["seq_mismatch"] = seq_mismatch
        # without the occupancy head only the finest level is read
        vox = self.img_bev_encoder_neck(self.img_bev_encoder_backbone(
            fused.permute(0, 4, 1, 2, 3)),
            n_out=None if self.occupancy_head is not None else 1)
        if self.occupancy_head is not None:
            outputs["occ_logits"] = self.occupancy_head(
                vox, return_labels=False, split=split)
            if split is not None:
                # the losses and the metric read the whole grid (JAX's
                # _occ_losses_sharded: in_specs P("data"))
                outputs["occ_logits"] = split.gather(outputs["occ_logits"], 1)
        if self.pts_bbox_head is not None:
            outputs["det_preds"] = self.detect(vox[0], split)
        return outputs, new_state

    def detect(self, vox0: torch.Tensor,
               split: Optional[parallel.RowSplit] = None):
        """The detection head on the finest 3D level (B, C, Y, X, Z): per
        task a dict of (B, Y, X, ch) maps.  Under a row split
        (:meth:`bev_split`) vox0 is this rank's rows and the head runs on
        the level gathered whole, a copy on every rank."""
        if split is not None:
            vox0 = split.gather(vox0, 2)
        # Z folded into channels as JAX's reshape of (B, Y, X, Z, C) to
        # (B, Y, X, Z*C): channel z*C + c.  This is vox0.permute(0, 4, 1,
        # 2, 3).reshape(B, Z*C, Y, X), made in channels-last memory (free
        # when vox0 is in channels_last_3d), which K7 and cuDNN read
        B, C, Y, X, Z = vox0.shape
        bev2d = vox0.permute(0, 2, 3, 4, 1).reshape(
            B, Y, X, Z * C).permute(0, 3, 1, 2)
        return self.pts_bbox_head(bev2d)


def init_weights(model: nn.Module, generator: Optional[torch.Generator]):
    """Random weights from ``generator``: LeCun-normal conv/linear kernels
    (the JAX package's default), zero biases (the detection heatmaps'
    -2.19), identity BatchNorm and LayerNorm, unit normal embeddings, and
    as the JAX backbones initialise them ConvNeXt's layer scales at 1e-6
    and Swin's relative-position bias tables truncated normal (0.02, cut
    at 2 standard deviations).  The sampling-offset and attention-weight
    layers keep their directional / zero init."""
    g = generator or torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith(("sampling_offsets", "attention_weights")):
                continue
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear,
                              nn.ConvTranspose3d)):
                w = m.weight
                fan_in = w[0].numel() if not isinstance(
                    m, nn.ConvTranspose3d) else w.shape[0] * w[0, 0].numel()
                w.copy_(torch.randn(w.shape, generator=g) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.modules.batchnorm._BatchNorm,
                                nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g))
            elif isinstance(m, convnext.ConvNeXtBlock):
                m.gamma.fill_(convnext.LAYER_SCALE_INIT)
            elif isinstance(m, swin.WindowMSA):
                t = m.relative_position_bias_table
                v = torch.randn(t.shape, generator=g)
                while bool((v.abs() > 2).any()):
                    out = v.abs() > 2
                    v[out] = torch.randn(int(out.sum()), generator=g)
                t.copy_(0.02 * v)
        # after the loop: it zeroed the biases the heads set
        for m in model.modules():
            if isinstance(m, SeparateHead):
                m.init_heatmap_bias()
