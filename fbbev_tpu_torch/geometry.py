"""Geometry core of the port: camera projection, frustum, BEV grid math and
the ego-motion flow matrix.  Counterpart of ``fbbev_tpu/geometry.py``.

Conventions are the JAX package's: BEV tensors are ``(B, Y, X, Z, C)``
channels-last with X the fastest spatial axis; voxel ranks are
``b*(nz*ny*nx) + z*(ny*nx) + y*nx + x``; image pixels are ``(u, v)`` =
(column, row).  The numpy helpers (grid, frustum, reference points) are
copies of the JAX package's numpy code; the tensor functions keep its op
order, because float rounding in ``frustum_to_ego`` decides which voxel a
point on a cell boundary lands in.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


class CamParams(NamedTuple):
    """Per-camera geometry of a batch of multi-camera frames."""

    rots: torch.Tensor        # (B, N, 3, 3) sensor -> key-ego rotation
    trans: torch.Tensor       # (B, N, 3)    sensor -> key-ego translation
    intrins: torch.Tensor     # (B, N, 3, 3) camera intrinsics
    post_rots: torch.Tensor   # (B, N, 3, 3) image-aug rotation / scale
    post_trans: torch.Tensor  # (B, N, 3)    image-aug translation
    bda: torch.Tensor         # (B, 3, 3)    BEV-plane augmentation

    def to(self, device) -> "CamParams":
        return CamParams(*(torch.as_tensor(t, dtype=torch.float32)
                           .to(device) for t in self))


def rot_z(angle_rad: float) -> np.ndarray:
    """Rotation about +z (the BEV-plane rotation), float32."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation (pyquaternion convention),
    float64, the copy of the JAX package's."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def gen_dx_bx(xb: Sequence[float], yb: Sequence[float],
              zb: Sequence[float]):
    """Grid cell size ``dx``, first-cell centre ``bx``, cell counts ``nx``."""
    rows = [xb, yb, zb]
    dx = np.array([r[2] for r in rows], np.float32)
    bx = np.array([r[0] + r[2] / 2.0 for r in rows], np.float32)
    nx = np.array([round((r[1] - r[0]) / r[2]) for r in rows], np.int32)
    return dx, bx, nx


def create_frustum(depth_cfg: Sequence[float], input_size: Tuple[int, int],
                   downsample: int) -> np.ndarray:
    """Frustum template ``(D, fH, fW, 3)`` of (u_px, v_px, depth_m)."""
    h_in, w_in = input_size
    fh, fw = h_in // downsample, w_in // downsample
    d = np.arange(depth_cfg[0], depth_cfg[1], depth_cfg[2], dtype=np.float32)
    D = d.shape[0]
    x = np.linspace(0, w_in - 1, fw, dtype=np.float32)
    y = np.linspace(0, h_in - 1, fh, dtype=np.float32)
    return np.stack([
        np.broadcast_to(x[None, None, :], (D, fh, fw)),
        np.broadcast_to(y[None, :, None], (D, fh, fw)),
        np.broadcast_to(d[:, None, None], (D, fh, fw)),
    ], axis=-1)


def frustum_to_ego(frustum: torch.Tensor, cam: CamParams) -> torch.Tensor:
    """Lift the frustum ``(D, fH, fW, 3)`` of every camera into the
    (BDA-augmented) ego frame: ``(B, N, D, fH, fW, 3)``."""
    f = torch.as_tensor(frustum, dtype=torch.float32,
                        device=cam.trans.device)
    pts = f[None, None] - cam.post_trans[:, :, None, None, None, :]
    inv_post = torch.linalg.inv(cam.post_rots)
    pts = torch.einsum("bnij,bndhwj->bndhwi", inv_post, pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
    combine = cam.rots @ torch.linalg.inv(cam.intrins)
    pts = torch.einsum("bnij,bndhwj->bndhwi", combine, pts)
    pts = pts + cam.trans[:, :, None, None, None, :]
    return torch.einsum("bij,bndhwj->bndhwi", cam.bda, pts)


def ego_to_cam_pixels(ref_xyz: torch.Tensor, cam: CamParams,
                      input_size: Tuple[int, int], eps: float = 1e-5):
    """Project ego points ``(Q, 3)`` into every camera's augmented image.

    Returns ``uv_norm (B, N, Q, 2)`` in [0, 1] by (W, H), ``mask (B, N, Q)``
    (in front of the camera and inside the image, ``eps`` margins) and
    ``depth (B, N, Q)``."""
    H, W = input_size
    pts = torch.einsum("bij,qj->bqi", torch.linalg.inv(cam.bda), ref_xyz)
    pts = pts[:, None] - cam.trans[:, :, None, :]
    combine = torch.linalg.inv(cam.rots @ torch.linalg.inv(cam.intrins))
    pcam = torch.einsum("bnij,bnqj->bnqi", combine, pts)
    z = pcam[..., 2:3]
    uv = pcam[..., :2] / torch.clamp(z, min=eps)
    pix = torch.cat([uv, z], -1)
    pix = torch.einsum("bnij,bnqj->bnqi", cam.post_rots, pix)
    pix = pix + cam.post_trans[:, :, None, :]
    u = pix[..., 0] / W
    v = pix[..., 1] / H
    depth = pix[..., 2]
    mask = ((depth > eps) & (u > eps) & (u < 1.0 - eps)
            & (v > eps) & (v < 1.0 - eps))
    return torch.stack([u, v], -1), mask, depth


def bev_reference_points_3d(x_bound, y_bound, z_bound) -> np.ndarray:
    """Voxel-centre anchors ``(ny, nx, nz, 3)`` of (x, y, z) centres."""
    xs = np.arange(*x_bound, dtype=np.float32) + x_bound[2] / 2.0
    ys = np.arange(*y_bound, dtype=np.float32) + y_bound[2] / 2.0
    zs = np.arange(*z_bound, dtype=np.float32) + z_bound[2] / 2.0
    Y, X, Z = np.meshgrid(ys, xs, zs, indexing="ij")
    return np.stack([X, Y, Z], axis=-1)


def bev_reference_points_2d(h: int, w: int) -> np.ndarray:
    """Normalised BEV self-attention reference points ``(h*w, 2)`` (x, y)."""
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h
    xs = (np.arange(w, dtype=np.float32) + 0.5) / w
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gx, gy], -1).reshape(h * w, 2)


def forward_aug_matrix(bda: torch.Tensor) -> torch.Tensor:
    """Embed the ``(B, 3, 3)`` BDA rotation into ``(B, 4, 4)`` matrices."""
    B = bda.shape[0]
    m = torch.eye(4, dtype=bda.dtype, device=bda.device).repeat(B, 1, 1)
    m[:, :3, :3] = bda
    return m


def feat2bev_matrix(dx: np.ndarray, bx: np.ndarray) -> np.ndarray:
    """BEV (x_idx, y_idx, z_idx, 1) -> ego metres homogeneous transform."""
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1], m[2, 2] = dx[0], dx[1], dx[2]
    m[0, 3] = bx[0] - dx[0] / 2.0
    m[1, 3] = bx[1] - dx[1] / 2.0
    m[2, 3] = bx[2] - dx[2] / 2.0
    m[3, 3] = 1.0
    return m


def flow_matrix_from_grid_args(history_forward_augs: torch.Tensor,
                               forward_augs: torch.Tensor,
                               curr_to_prev_ego_rt: torch.Tensor,
                               feat2bev: torch.Tensor) -> torch.Tensor:
    """The ``(B, 4, 4)`` affine history flow in voxel-index units: output
    (x, y, z) index coords -> source index coords.  Counterpart of
    ``fbbev_tpu/ops/pallas_warp.py::flow_matrix_from_grid_args``."""
    return (torch.linalg.inv(feat2bev)[None]
            @ history_forward_augs
            @ curr_to_prev_ego_rt
            @ torch.linalg.inv(forward_augs)
            @ feat2bev[None])


def flow_grid(mat: torch.Tensor, grid_zyx: Tuple[int, int, int]
              ) -> torch.Tensor:
    """The ``(B, Y, X, Z, 3)`` sampling grid, (x, y, z) in [-1, 1] for an
    align_corners=True trilinear sample, of the ``(B, 4, 4)`` index-unit
    flow ``mat``, in its dtype: the source of output voxel (y, x, z).
    ``fbbev_tpu/geometry.py::history_flow_grid`` of the same flow,
    transposed from (B, Z, Y, X, 3)."""
    z, h, w = grid_zyx
    dev, dt = mat.device, mat.dtype
    gy, gx, gz = torch.meshgrid(
        torch.arange(h, dtype=dt, device=dev),
        torch.arange(w, dtype=dt, device=dev),
        torch.arange(z, dtype=dt, device=dev), indexing="ij")
    grid = torch.stack([gx, gy, gz, torch.ones_like(gx)], -1)
    warped = torch.einsum("bij,hwzj->bhwzi", mat, grid)[..., :3]
    norm = torch.tensor([w - 1.0, h - 1.0, z - 1.0], dtype=dt, device=dev)
    return warped / norm * 2.0 - 1.0
