"""The port's ``FBOCC`` config switches against the JAX model's, on the
serving stream at the slice tests' small size in float32: no backward
projection, a ResNet-10 / ResNet-18 backbone (basic blocks, FPN inputs
(256, 512)) and a non-default ``pc_range``.  Weights are numpy-seeded
JAX variables loaded into the port with ``strict=True``; the JAX side
runs its voxel pool and fused history warp through the Pallas
interpreter, as ``test_torch_slice.py`` does.  Also the eval forward's
history fusion against the JAX forward's, and the bf16 rounding of the
plain upsample's lerp weights (``layers.upsample_int_axis``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.models import FBOCC as JaxFBOCC
from fbbev_tpu.models.fbocc import init_temporal_state as jax_init_state
from fbbev_tpu_torch.models import FBOCC
from fbbev_tpu_torch.weights import load_jax_variables

from tests.test_torch_slice import SMALL, assert_off_voxel_faces, flow, \
    jax_cam, rig, torch_cam

torch.set_num_threads(1)

SWITCHES = {
    "no_backward_projection": dict(use_backward_projection=False),
    "resnet10": dict(backbone_depth=10),
    "resnet18": dict(backbone_depth=18),
    "pc_range": dict(pc_range=(-36.0, -44.0, -2.0, 44.0, 36.0, 6.0)),
}


def jax_variables(model, seed=0):
    """numpy-seeded variables of a small JAX model, drawn as
    ``test_torch_slice.jax_variables`` draws them (BatchNorm statistics
    and scales away from identity)."""
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


def run_streams(jm, variables, tm, monkeypatch, frames=4):
    """The JAX and the port's FixedRigPipeline over one stream (starts at
    frames 0 and 3); per frame (JAX labels, port labels), and the JAX
    pipeline."""
    from fbbev_tpu.serving import FixedRigPipeline as JaxPipeline
    from fbbev_tpu_torch.serving import FixedRigPipeline
    monkeypatch.setenv("FBBEV_FORCE_POOL", "interpret")
    monkeypatch.setenv("FBBEV_FORCE_FUSE_WARP", "interpret")
    cam = rig()
    assert_off_voxel_faces(cam)
    jp = JaxPipeline(jm, variables, jax_cam(cam))
    tp = FixedRigPipeline(tm, torch_cam(cam))
    rng = np.random.RandomState(1)
    out = []
    for i in range(frames):
        start = i in (0, 3)
        imgs = rng.randn(1, 2, 64, 128, 3).astype(np.float32)
        rt = flow(0 if start else i)
        want = np.asarray(jp(imgs, start, rt))
        got = tp(imgs, start, rt).numpy()
        hj = np.asarray(jp.state.history_bev)
        ht = tp.state.history_bev.numpy()
        assert np.abs(hj - ht).max() <= 1e-4 * np.abs(hj).max(), i
        np.testing.assert_array_equal(np.asarray(jp.state.sweep_time),
                                      tp.state.sweep_time.numpy())
        out.append((want, got))
    return out, jp, tp


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switch_stream_matches_jax(switch, monkeypatch):
    """Labels agree on >= 99.9% of voxels every frame and the ring state
    matches (the slice test's tolerances); the module structure follows
    the switch and loads the JAX weights with ``strict=True``."""
    kw = dict(SMALL, **SWITCHES[switch])
    jm = JaxFBOCC(**kw)
    v = jax_variables(jm)
    tm = load_jax_variables(FBOCC(**kw, device="cpu"), v)
    if switch == "no_backward_projection":
        assert "backward_projection" not in v["params"]
        assert tm.backward_projection is None
    else:
        assert tm.backward_projection.pc_range == tuple(kw.get(
            "pc_range", (-40, -40, -1.0, 40, 40, 5.4)))
    if switch.startswith("resnet"):
        assert not hasattr(tm.img_backbone.layer1[0], "conv3")
        assert tm.img_neck.lateral_convs[1].conv.in_channels == 512
    out, jp, tp = run_streams(jm, v, tm, monkeypatch)
    for i, (want, got) in enumerate(out):
        assert got.shape == want.shape == (1, 40, 40, 16)
        assert (got == want).mean() >= 0.999, (i, (got == want).mean())
    assert (tp.bwd_terms is None) == (switch == "no_backward_projection")


def test_eval_forward_fuses_history_on_k1_as_jax(monkeypatch):
    """``FBOCC.forward`` in eval (the benchmark tool's inference) fuses
    history on the ring slots through K1, as the JAX forward's fused path
    (``fbocc.py:350-421``) does: over 3 frames (a start at frame 2) the
    labels agree on >= 99.9% of voxels, the ring history to 1e-4 of its
    largest value and the slot ages exactly; the aged fallback never
    runs."""
    from fbbev_tpu_torch.models import fbocc as port_fbocc
    from fbbev_tpu_torch.models.fbocc import init_temporal_state
    from fbbev_tpu_torch.ops import pallas_fuse_warp
    monkeypatch.setenv("FBBEV_FORCE_FUSE_WARP", "interpret")
    jm = JaxFBOCC(**SMALL)
    v = jax_variables(jm)
    tm = load_jax_variables(FBOCC(**SMALL, device="cpu"), v)
    calls = []
    real = pallas_fuse_warp.fuse_warp
    monkeypatch.setattr(pallas_fuse_warp, "fuse_warp", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    monkeypatch.setattr(port_fbocc.FBOCC, "fuse_history_aged",
                        lambda *a, **k: pytest.fail("aged fallback ran"))
    cam = rig()
    js, ts = jax_init_state(1, (20, 20, 8), 2, 64), init_temporal_state(
        1, (20, 20, 8), 2, 64, device="cpu")
    # one jitted forward for the three frames: the Pallas interpreter
    # runs K1 inside the compiled program, not op by op
    japply = jax.jit(lambda v, b, s: jm.apply(v, b, s, train=False))
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for i in range(3):
            start = i in (0, 2)
            batch = dict(cam, imgs=rng.randn(1, 2, 64, 128, 3).astype(
                np.float32), start_of_sequence=np.array([start]),
                sequence_group_idx=np.zeros(1, np.int32),
                curr_to_prev_ego_rt=flow(0 if start else i))
            jo, js = japply(v, {k: jnp.asarray(x) for k, x in
                                batch.items()}, js)
            to, ts = tm({k: torch.from_numpy(np.asarray(x)) for k, x in
                         batch.items()}, ts, train=False)
            want = np.asarray(jo["occ_logits"]).argmax(-1)
            got = to["occ_logits"].argmax(-1).numpy()
            assert (got == want).mean() >= 0.999, (i, (got == want).mean())
            hj, ht = np.asarray(js.history_bev), ts.history_bev.numpy()
            assert np.abs(hj - ht).max() <= 1e-4 * np.abs(hj).max(), i
            np.testing.assert_array_equal(np.asarray(js.sweep_time),
                                          ts.sweep_time.numpy())
            assert not to["seq_mismatch"].any()
    assert len(calls) == 3


def test_pc_range_reaches_the_backward_projection():
    """Without a BEVFormer grid of its own the head's anchors span
    ``pc_range``, as the JAX ``BackwardProjection._grid_cfg`` has it."""
    from fbbev_tpu.models.bevformer import BackwardProjection as JaxBP
    from fbbev_tpu_torch.models.bevformer import BackwardProjection
    r = (-36.0, -44.0, -2.0, 44.0, 36.0, 6.0)
    want = JaxBP(bev_h=20, bev_w=25, pc_range=r)._grid_cfg()
    got = BackwardProjection(20, 25, 16, 64, 8, None, (64, 128),
                             (2.0, 42.0, 0.5), pc_range=r).grid_config
    assert got == want


def test_no_occupancy_head():
    """Without the head the model returns no ``occ_logits`` and serving
    refuses it; its weights are the JAX model's without that subtree."""
    from fbbev_tpu_torch.serving import FixedRigPipeline
    from fbbev_tpu_torch.weights import to_state_dict
    kw = dict(SMALL, use_occupancy_head=False)
    tm = FBOCC(**kw, device="cpu")
    assert tm.occupancy_head is None
    v = jax_variables(JaxFBOCC(**kw))
    assert "occupancy_head" not in v["params"]
    load_jax_variables(tm, v)
    assert not any(k.startswith("occupancy_head") for k in to_state_dict(v))
    with pytest.raises(ValueError, match="occupancy head"):
        FixedRigPipeline(tm, torch_cam(rig()))


def test_upsample_int_axis_bf16_factor_3_matches_jax():
    """Factor 3 (lerp weights 1/3, 2/3 that bf16 cannot hold): each weight
    rounded to bf16 first, as JAX rounds the Python float: equal bit for
    bit along every axis."""
    from fbbev_tpu.models import layers as jlayers
    from fbbev_tpu_torch.models.layers import upsample_int_axis
    x = np.random.RandomState(3).randn(2, 5, 6, 7, 3).astype(np.float32)
    for axis in (1, 2, 3):
        want = np.asarray(jlayers._upsample_int_axis(
            jnp.asarray(x, jnp.bfloat16), axis, 3).astype(jnp.float32))
        got = upsample_int_axis(torch.from_numpy(x).bfloat16(), axis,
                                3).float().numpy()
        np.testing.assert_array_equal(got, want)
