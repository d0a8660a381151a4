"""Lift-splat-shoot forward projection.  Counterpart of
``fbbev_tpu/models/lss.py::LSSViewTransformer3D``: parameter-free grid
metadata, and the splat of one batch (:meth:`__call__`) with its frustum
lifted through that batch's cameras and pooled by the differentiable
segment sum (``ops/bev_pool.py``), as training does: it does not hoist
the rig.  Serving pools with K2 (``ops/pallas_pool.py``) over ranks
computed once per rig on the host."""

from __future__ import annotations

from typing import Tuple

import torch

from fbbev_tpu_torch import geometry, parallel
from fbbev_tpu_torch.ops.bev_pool import lss_voxel_pool


class LSSViewTransformer3D:
    def __init__(self, grid_config, input_size: Tuple[int, int],
                 downsample: int = 16):
        self.grid_config = dict(grid_config)
        self.input_size = tuple(input_size)
        self.downsample = downsample
        self.dx, self.bx, self.nx = geometry.gen_dx_bx(
            grid_config["x"], grid_config["y"], grid_config["z"])
        self.grid_lower = [grid_config[k][0] for k in "xyz"]
        self.grid_interval = [grid_config[k][2] for k in "xyz"]
        self.grid_size = tuple(int(n) for n in self.nx)  # (nx, ny, nz)
        self.frustum = geometry.create_frustum(
            grid_config["depth"], self.input_size, downsample)
        self.D = self.frustum.shape[0]

    def __call__(self, cam: geometry.CamParams, context: torch.Tensor,
                 depth: torch.Tensor) -> torch.Tensor:
        """context (B, N, fH, fW, C); depth (B, N, D, fH, fW) -> (B, Y, X,
        Z, C) float32 voxel features."""
        coor = geometry.frustum_to_ego(torch.from_numpy(self.frustum), cam)
        # under a mesh with a 'space' axis, this rank's cameras' partial
        # sum, summed over the axis (JAX ``lss.py::_pool``'s psum)
        return parallel.all_reduce_sum(
            lss_voxel_pool(coor, depth.float(), context.float(),
                           self.grid_lower, self.grid_interval,
                           self.grid_size), "space")
