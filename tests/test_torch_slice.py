"""The port's serving slice against the JAX package, end to end on CPU.

Both pipelines run the same small FB-OCC (weights made from a numpy seed
and converted with ``fbbev_tpu_torch.weights``) over the same 5-frame
stream with sequence starts at frames 0 and 3 and small ego motion inside
the fused warp's locality contract.  JAX runs its TPU kernels through the
Pallas interpreter (the voxel pool and the fused history warp); the port
runs its kernels' plain PyTorch versions.  Everything is float32; the
served bf16 path is held against JAX's bf16 by ``test_torch_bf16.py``,
module by module and over two frames of this stream (its tolerances:
the port's bf16 no farther from float32 than 1.1 x JAX's, and the two
bf16 results within each module's stated k x JAX's bf16 error).

The small config passes the JAX kernel gates: a 64x128 input (fH*fW a
multiple of 8 for the pool), a 20x20x8 grid (Y, X multiples of 10 for the
warp), 64 BEV channels and 2 history frames (T*C a multiple of
lcm(C, 128)), and 256 < 400 queries per camera (the rebatch runs).

This file also holds the small-model helpers the other ``test_torch_*``
files import.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu import geometry as jgeo
from fbbev_tpu.models import FBOCC as JaxFBOCC
from fbbev_tpu.models.fbocc import init_temporal_state as jax_init_state
from fbbev_tpu_torch import geometry as tgeo
from fbbev_tpu_torch.models import FBOCC
from fbbev_tpu_torch.weights import load_jax_variables

torch.set_num_threads(1)

GRID = {"x": (-40.0, 40.0, 4.0), "y": (-40.0, 40.0, 4.0),
        "z": (-1.0, 5.4, 0.8), "depth": (2.0, 42.0, 0.5)}
BF_GRID = {"x": (-40.0, 40.0, 4.0), "y": (-40.0, 40.0, 4.0),
           "z": (-1.0, 5.4, 1.6)}
SMALL = dict(grid_config=GRID, bevformer_grid_config=BF_GRID,
             input_size=(64, 128), num_cams=2, history_cat_num=2,
             single_bev_num_channels=64, history_cat_conv_out_channels=128,
             depth_mid_channels=64, voxel_channels=(16, 32, 64),
             voxel_out_channels=32, max_queries_per_cam=256)
CAM_KEYS = ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")


# sub-cell offset of the camera translations: keeps every frustum point of
# the rig off the voxel faces (see assert_off_voxel_faces)
RIG_OFFSET = 0.0137


def rig(N=2, H=64, W=128, f=100.0):
    """N horizontal cameras around the ego at 1.5 m, (1, N, ...) numpy."""
    rots, trans, intr = [], [], []
    for n in range(N):
        th = 2 * np.pi * n / N
        fwd = [np.cos(th), np.sin(th), 0.0]
        right = [np.sin(th), -np.cos(th), 0.0]
        rots.append(np.stack([right, [0.0, 0.0, -1.0], fwd], 1))
        trans.append([0.1 * n + RIG_OFFSET, 0.05 * n + RIG_OFFSET,
                      1.5 + RIG_OFFSET])
        intr.append([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    f32 = (lambda a: np.asarray(a, np.float32))
    return dict(rots=f32(rots)[None], trans=f32(trans)[None],
                intrins=f32(intr)[None],
                post_rots=f32(np.tile(np.eye(3), (1, N, 1, 1))),
                post_trans=np.zeros((1, N, 3), np.float32),
                bda=f32(np.eye(3))[None])


def jax_cam(cam):
    return jgeo.CamParams(**{k: jnp.asarray(cam[k]) for k in CAM_KEYS})


def torch_cam(cam):
    return tgeo.CamParams(**{k: torch.from_numpy(cam[k]) for k in CAM_KEYS})


def assert_off_voxel_faces(cam, grid=GRID, input_size=(64, 128),
                           margin=1e-4):
    """No frustum point of the rig lies within ``margin`` cells of a voxel
    face, in the JAX package's float32 ego coordinates.  XLA and PyTorch
    round the lifting einsums differently (~1e-7 m), so a point on a face
    could land in either voxel; with this margin the voxel ranks of the
    two packages are equal on any machine."""
    from fbbev_tpu.models.lss import LSSViewTransformer3D
    fp = LSSViewTransformer3D(grid, input_size, 16)
    coor = np.asarray(jgeo.frustum_to_ego(jnp.asarray(fp.frustum),
                                          jax_cam(cam)))
    c = ((coor - np.asarray(fp.grid_lower, np.float32))
         / np.asarray(fp.grid_interval, np.float32))
    gap = np.abs(c - np.round(c)).min()
    assert gap > margin, f"a frustum point lies {gap} cells from a face"


def flow(step):
    """curr->prev ego motion of stream step ``step`` (identity at 0):
    yaw 0.03*step rad and under half a cell of translation."""
    th = 0.03 * step
    c2p = np.eye(4, dtype=np.float32)
    c2p[0, 0] = c2p[1, 1] = np.cos(th)
    c2p[0, 1], c2p[1, 0] = -np.sin(th), np.sin(th)
    c2p[0, 3], c2p[1, 3] = 0.4 * step, -0.25 * min(step, 1)
    c2p[2, 3] = 0.1 * min(step, 1)
    return c2p[None]


def jax_model():
    return JaxFBOCC(**SMALL)


def jax_variables(seed=0):
    """Variables of the small JAX model with numpy-seeded values (shapes
    from ``eval_shape``; a real ``init`` of the whole model takes a
    minute on CPU)."""
    model = jax_model()
    batch = dict(imgs=jnp.zeros((1, 2, 64, 128, 3)),
                 **{k: jnp.asarray(v) for k, v in rig().items()},
                 start_of_sequence=jnp.ones((1,), bool),
                 sequence_group_idx=jnp.zeros((1,), jnp.int32),
                 curr_to_prev_ego_rt=jnp.eye(4)[None])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch,
                            jax_init_state(1, (20, 20, 8), 2, 64))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        names = [getattr(p, "key", None) for p in path]
        shape, name = s.shape, names[-1]
        if names[0] == "batch_stats":
            v = (rng.rand(*shape) * 0.5 + 0.5 if name == "var"
                 else rng.randn(*shape) * 0.1)
        elif name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = rng.rand(*shape) * 0.5 + 0.75
        elif name == "bias":
            v = rng.randn(*shape) * (2.0 if "sampling_offsets" in names
                                     else 0.1)
        else:  # embeddings
            v = rng.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def port_model(variables):
    return load_jax_variables(FBOCC(**SMALL, device="cpu"), variables)


@pytest.fixture(scope="module")
def models():
    v = jax_variables()
    return jax_model(), v, port_model(v)


def test_serving_stream_matches_jax(models, monkeypatch):
    """Labels agree on >= 99.9% of voxels every frame (logits near an
    argmax tie may flip with f32 summation order) and the ring state
    (history in ring slots, slot ages) matches: history to 1e-4 relative
    to its largest value, ages exactly."""
    from fbbev_tpu.ops import pallas_fuse_warp, pallas_pool
    from fbbev_tpu.serving import FixedRigPipeline as JaxPipeline
    from fbbev_tpu_torch.serving import FixedRigPipeline

    jm, v, tm = models
    monkeypatch.setenv("FBBEV_FORCE_POOL", "interpret")
    monkeypatch.setenv("FBBEV_FORCE_FUSE_WARP", "interpret")
    traced = []
    for mod, fn in ((pallas_pool, "lss_voxel_pool_planned"),
                    (pallas_fuse_warp, "fuse_warp")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, (lambda *a, _r=real, _n=fn, **k: (
            traced.append(_n), _r(*a, **k))[1]))
    cam = rig()
    assert_off_voxel_faces(cam)
    jp = JaxPipeline(jm, v, jax_cam(cam))
    assert jp.pool_plan is not None            # JAX runs its pool kernel
    tp = FixedRigPipeline(tm, torch_cam(cam))
    np.testing.assert_array_equal(np.asarray(jp.ranks_bev), tp.ranks)

    rng = np.random.RandomState(1)
    for i, start in enumerate([True, False, False, True, False]):
        imgs = rng.randn(1, 2, 64, 128, 3).astype(np.float32)
        rt = flow(0 if start else i)
        want = np.asarray(jp(imgs, start, rt))
        got = tp(imgs, start, rt).numpy()
        assert got.shape == want.shape == (1, 40, 40, 16)
        assert (got == want).mean() >= 0.999, (i, (got == want).mean())
        hj = np.asarray(jp.state.history_bev)
        ht = tp.state.history_bev.numpy()
        assert np.abs(hj - ht).max() <= 1e-4 * np.abs(hj).max(), i
        np.testing.assert_array_equal(np.asarray(jp.state.sweep_time),
                                      tp.state.sweep_time.numpy())
    # the JAX side went through both of its kernels
    assert set(traced) == {"lss_voxel_pool_planned", "fuse_warp"}
