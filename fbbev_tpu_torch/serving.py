"""Fixed-rig streaming occupancy inference.  Counterpart of
``fbbev_tpu/serving.py::FixedRigPipeline``.

Everything that depends only on the calibrated rig is computed once at
construction: the voxel ranks and K2's sorted interval plan (on the host,
float32 numpy), the backward projection's rebatch indices, anchors,
depth one-hots and dense depth-sampling matrix, and the camera MLP input.
Each call then runs one frame on the device and carries the temporal
state; :meth:`FixedRigPipeline.benchmark` times a stream of them.  Three
hand-written kernels run per frame by default: K2 (voxel pool), K3
(deformable sampling, twice: self- and cross-attention; not without the
backward projection) and K1 (history warp with the conv epilogue).  The
model's route arguments add others: with ``fuse_warp=False`` the history
stays age-ordered (same shape, other slot order) and K5 warps it in place
of K1; ``pallas_conv3d`` runs the stride-1 3x3x3 convs on K6;
``occ_tail`` and ``occ_fuse`` run the occ head's tail on K8 or its blend
on K9.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from fbbev_tpu_torch import geometry, host_lib
from fbbev_tpu_torch.models.depth_net import get_mlp_input
from fbbev_tpu_torch.models.fbocc import FBOCC, TemporalState, \
    init_temporal_state
from fbbev_tpu_torch.ops.pallas_pool import lss_voxel_pool_planned, \
    plan_pool


def stage(name: str):
    """Profiler range of one serving stage (``serving/<name>``); costs a
    few microseconds of host time when no profiler is running."""
    return torch.profiler.record_function("serving/" + name)


class FixedRigPipeline:
    """Streaming multi-camera occupancy inference for one calibrated rig.
    Runs on the model's device."""

    def __init__(self, model: FBOCC, cam: geometry.CamParams):
        if model.occupancy_head is None:
            raise ValueError("FixedRigPipeline serves occupancy labels: the "
                             "model has no occupancy head")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        cam_cpu = cam.to("cpu")
        self.cam = cam.to(self.device)
        fp = model.forward_projection
        self.grid = fp.grid_size
        B, N = cam_cpu.trans.shape[:2]
        self.batch = B
        fH, fW = (s // fp.downsample for s in model.input_size)

        coor = geometry.frustum_to_ego(torch.from_numpy(fp.frustum),
                                       cam_cpu).numpy().reshape(-1, 3)
        batch_idx = np.repeat(np.arange(B, dtype=np.int32), len(coor) // B)
        self.ranks = host_lib.compute_voxel_ranks(
            coor, batch_idx, fp.grid_lower, fp.grid_interval, self.grid, B)
        self.pool_plan = plan_pool(self.ranks, B, N, fp.D, fH, fW,
                                   self.grid).to(self.device)
        self.bwd_terms = None
        if model.backward_projection is not None:
            terms = model.backward_projection.static_terms(
                cam_cpu, model.depth_channels, (fH, fW))
            self.bwd_terms = {k: v.to(self.device) for k, v in terms.items()}
        self.mlp_input = get_mlp_input(self.cam)
        self.state = init_temporal_state(
            B, self.grid, model.history_cat_num,
            model.single_bev_num_channels, dtype=model.dtype,
            device=self.device)

    @torch.no_grad()
    def _fwd(self, imgs: torch.Tensor, meta: dict, state: TemporalState):
        mdl = self.model
        with stage("image_encoder"):
            feats = mdl.image_encoder(imgs)
        with stage("depth_net"):
            context, depth = mdl.depth_net(feats, self.mlp_input)
        with stage("voxel_pool"):
            bev = lss_voxel_pool_planned(self.pool_plan, depth.contiguous(),
                                         context.contiguous())
        if mdl.backward_projection is not None:
            with stage("backward_projection"):
                lss_bev = bev.mean(dim=3)
                refined = mdl.backward_projection(
                    context, lss_bev.to(mdl.dtype), depth, self.bwd_terms)
                bev = refined.float()[:, :, :, None, :] + bev
        with stage("fuse_history"):
            fuse = (mdl.fuse_history if mdl.fuse_warp
                    else mdl.fuse_history_aged)
            fused, new_state, _ = fuse(bev, state, meta, self.cam.bda)
        with stage("bev_encoder"):
            vox = mdl.img_bev_encoder_neck(mdl.img_bev_encoder_backbone(
                fused.permute(0, 4, 1, 2, 3)))
        with stage("occ_head"):
            labels = mdl.occupancy_head(vox)
        return labels, new_state

    def __call__(self, imgs, start_of_sequence: bool,
                 curr_to_prev_ego_rt: Optional[np.ndarray] = None):
        """One streaming step.  imgs (B, N, H, W, 3) normalised; returns
        (B, Y, X, Z) occupancy labels on the device."""
        B, dev = self.batch, self.device
        rt = (np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
              if curr_to_prev_ego_rt is None else curr_to_prev_ego_rt)
        meta = dict(
            start_of_sequence=torch.full((B,), bool(start_of_sequence),
                                         device=dev),
            sequence_group_idx=torch.zeros(B, dtype=torch.int32, device=dev),
            curr_to_prev_ego_rt=torch.as_tensor(
                np.asarray(rt, np.float32)).to(dev))
        labels, self.state = self._fwd(torch.as_tensor(imgs).to(dev), meta,
                                       self.state)
        return labels

    def benchmark(self, iters: int = 20,
                  include_transfer: bool = False) -> float:
        """Frames per second of this pipeline on its device, as the JAX
        ``FixedRigPipeline.benchmark``: three numpy-seeded frames staged on
        the device (kept on the host with ``include_transfer``, so that
        each step copies its images), a sequence start and three steady
        frames, then ``iters`` steady frames on the host clock, ended by
        a device sync."""
        rng = np.random.RandomState(0)
        H, W = self.model.input_size
        imgs = [torch.from_numpy(rng.randn(
            self.batch, self.model.num_cams, H, W, 3).astype(np.float32))
            for _ in range(3)]
        if not include_transfer:
            imgs = [im.to(self.device) for im in imgs]
        self(imgs[0], True)
        self._sync()
        for im in imgs:
            self(im, False)
        self._sync()
        t0 = time.perf_counter()
        for i in range(iters):
            self(imgs[i % 3], False)
        self._sync()
        return self.batch * iters / (time.perf_counter() - t0)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
