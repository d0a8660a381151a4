"""The port's geometry and host rank math against the JAX package.

Ranks decide which voxel every frustum point pools into; a point within
float rounding of a cell boundary could land in the neighbour cell if the
two frameworks rounded ``frustum_to_ego`` differently, so the rank test
counts such points (it finds none: both evaluate the same float32 op
order).  Tolerances: float32 geometry to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu import geometry as jgeo
from fbbev_tpu.ops import host_lib as jhost
from fbbev_tpu.ops import pallas_warp
from fbbev_tpu_torch import geometry as tgeo
from fbbev_tpu_torch import host_lib as thost

from tests.test_torch_slice import flow, jax_cam, rig, torch_cam

torch.set_num_threads(1)

FLAG_GRID = ((-40.0, 40.0, 0.8), (-40.0, 40.0, 0.8), (-1.0, 5.4, 0.8))


def _flagship_cam(rng):
    """A 6-camera 256x704 rig with image augmentation and BDA."""
    cam = rig(N=6, H=256, W=704, f=560.0)
    th = rng.uniform(-0.1, 0.1, 6)
    pr = np.tile(np.eye(3, dtype=np.float32), (1, 6, 1, 1))
    pr[0, :, 0, 0] = pr[0, :, 1, 1] = (1.0 + 0.05 * np.cos(th))
    pr[0, :, 0, 1], pr[0, :, 1, 0] = -0.05 * np.sin(th), 0.05 * np.sin(th)
    cam["post_rots"] = pr.astype(np.float32)
    cam["post_trans"] = rng.uniform(-8, 8, (1, 6, 3)).astype(np.float32)
    cam["post_trans"][..., 2] = 0.0
    cam["bda"] = jgeo.rot_z(0.2)[None].astype(np.float32)
    return cam


def test_grid_frustum_and_reference_points():
    for a, b in zip(jgeo.gen_dx_bx(*FLAG_GRID), tgeo.gen_dx_bx(*FLAG_GRID)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        jgeo.create_frustum((2.0, 42.0, 0.5), (256, 704), 16),
        tgeo.create_frustum((2.0, 42.0, 0.5), (256, 704), 16))
    np.testing.assert_array_equal(
        jgeo.bev_reference_points_3d(*FLAG_GRID[:2], (-1.0, 5.4, 1.6)),
        tgeo.bev_reference_points_3d(*FLAG_GRID[:2], (-1.0, 5.4, 1.6)))
    np.testing.assert_array_equal(jgeo.bev_reference_points_2d(100, 80),
                                  tgeo.bev_reference_points_2d(100, 80))


def test_frustum_to_ego_and_ranks_match():
    """Ego points to 1e-5 relative; voxel ranks of the flagship frustum
    (337,920 points) exactly equal."""
    cam = _flagship_cam(np.random.RandomState(0))
    fr = tgeo.create_frustum((2.0, 42.0, 0.5), (256, 704), 16)
    want = np.asarray(jgeo.frustum_to_ego(jnp.asarray(fr), jax_cam(cam)))
    got = tgeo.frustum_to_ego(torch.from_numpy(fr), torch_cam(cam)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    lower = [g[0] for g in FLAG_GRID]
    step = [g[2] for g in FLAG_GRID]
    bidx = np.zeros(want.size // 3, np.int32)
    rj = jhost.compute_voxel_ranks(want.reshape(-1, 3), bidx, lower, step,
                                   (100, 100, 8), 1)
    rt = thost.compute_voxel_ranks(got.reshape(-1, 3), bidx, lower, step,
                                   (100, 100, 8), 1)
    assert (rj < 80000).sum() > 100000          # the rig sees the grid
    assert int((rj != rt).sum()) == 0


def test_sort_ranks_intervals_matches(rng):
    ranks = rng.randint(0, 500, size=4000).astype(np.int32)
    for a, b in zip(jhost.sort_ranks_intervals(ranks),
                    thost.sort_ranks_intervals(ranks)):
        np.testing.assert_array_equal(a, b)


def test_ego_to_cam_pixels_matches(rng):
    cam = _flagship_cam(rng)
    ref = jgeo.bev_reference_points_3d(*FLAG_GRID[:2], (-1.0, 5.4, 1.6))
    ref = ref.reshape(-1, 3)
    uj, mj, dj = (np.asarray(a) for a in jgeo.ego_to_cam_pixels(
        jnp.asarray(ref), jax_cam(cam), (256, 704)))
    ut, mt, dt = (a.numpy() for a in tgeo.ego_to_cam_pixels(
        torch.from_numpy(ref), torch_cam(cam), (256, 704)))
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-4)
    # uv of points behind a camera are huge; compare where visible
    np.testing.assert_allclose(ut[mj], uj[mj], rtol=1e-5, atol=1e-5)
    # visibility may flip only for points within rounding of the border
    assert (mt != mj).sum() <= 2


@pytest.mark.parametrize("step", [1, 3])
def test_flow_matrix_matches(step):
    """The index-unit history flow of K1 and K5 and the normalised warp
    grid it encodes (``flow_grid``, K5's plain version), against the JAX
    package (1e-5)."""
    rng = np.random.RandomState(step)
    dx, bx, _ = tgeo.gen_dx_bx(*FLAG_GRID)
    f2b = tgeo.feat2bev_matrix(dx, bx)
    np.testing.assert_array_equal(f2b, jgeo.feat2bev_matrix(dx, bx))
    bda = np.stack([jgeo.rot_z(a) for a in rng.uniform(-0.3, 0.3, 2)])
    fa = tgeo.forward_aug_matrix(torch.from_numpy(bda))
    np.testing.assert_array_equal(
        fa.numpy(), np.asarray(jgeo.forward_aug_matrix(jnp.asarray(bda))))
    ha = fa.flip(0)
    c2p = np.concatenate([flow(step), flow(step + 1)])
    want = np.asarray(pallas_warp.flow_matrix_from_grid_args(
        jnp.asarray(ha.numpy()), jnp.asarray(fa.numpy()), jnp.asarray(c2p),
        jnp.asarray(f2b)))
    got = tgeo.flow_matrix_from_grid_args(ha, fa, torch.from_numpy(c2p),
                                          torch.from_numpy(f2b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    grid = np.asarray(jgeo.history_flow_grid(
        jnp.asarray(ha.numpy()), jnp.asarray(fa.numpy()), jnp.asarray(c2p),
        jnp.asarray(f2b), (8, 100, 100)))
    z, y, x = 5, 17, 63
    src = got[:, :3] @ np.array([x, y, z, 1.0], np.float32)
    norm = src / np.array([99.0, 99.0, 7.0]) * 2.0 - 1.0
    np.testing.assert_allclose(norm, grid[:, z, y, x], atol=1e-5)
    tgrid = tgeo.flow_grid(torch.from_numpy(got), (8, 100, 100)).numpy()
    np.testing.assert_allclose(tgrid, grid.transpose(0, 2, 3, 1, 4),
                               atol=1e-5)
