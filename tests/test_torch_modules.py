"""The port's modules against the JAX package's, one stage at a time, on
the small model of ``test_torch_slice`` (same weights, float32).

Tolerance: each stage's output to 1e-4 of its largest magnitude -- deep
float32 convolution stacks summed in different orders by XLA and oneDNN
(ResNet-50 is 53 convolutions deep) -- and the occupancy labels to 99.9%
(near-ties of the argmax may flip).  The trouble-spot tests pin the
details that differ between the frameworks: resize semantics, explicit
paddings and the deconvolution kernel flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from fbbev_tpu.models.depth_net import get_mlp_input as jax_mlp_input
from fbbev_tpu.serving import nn_apply
from fbbev_tpu_torch.models import layers as tl
from fbbev_tpu_torch.models.depth_net import get_mlp_input

from tests.test_torch_slice import jax_cam, models, rig, torch_cam  # noqa

torch.set_num_threads(1)


def close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _jax(models, fn):
    """``fn`` of the bound JAX model, jitted: one compiled program per
    stage runs faster on the CPU than the stage op by op."""
    jm, v, _ = models
    return jax.jit(lambda v: nn_apply(jm, v, fn))(v)


@pytest.fixture(scope="module")
def stages(models):
    """JAX stage outputs on one frame (inputs of the next stage)."""
    rng = np.random.RandomState(11)
    imgs = rng.randn(1, 2, 64, 128, 3).astype(np.float32)
    cam = rig()
    mlp = jax_mlp_input(jax_cam(cam))
    feats = _jax(models, lambda m: m.image_encoder(jnp.asarray(imgs), False))
    ctx, depth = _jax(models, lambda m: m.depth_net(feats, mlp, False))
    return dict(imgs=imgs, cam=cam, feats=np.asarray(feats),
                ctx=np.asarray(ctx), depth=np.asarray(depth))


@torch.no_grad()
def test_image_encoder_matches(models, stages):
    got = models[2].image_encoder(torch.from_numpy(stages["imgs"]))
    close(got.numpy(), stages["feats"])


@torch.no_grad()
def test_depth_net_matches(models, stages):
    cam = stages["cam"]
    mlp = get_mlp_input(torch_cam(cam))
    close(mlp.numpy(), jax_mlp_input(jax_cam(cam)), rel=1e-6)
    ctx, depth = models[2].depth_net(torch.from_numpy(stages["feats"]), mlp)
    close(ctx.numpy(), stages["ctx"])
    close(depth.numpy(), stages["depth"])


@torch.no_grad()
def test_backward_projection_matches(models, stages):
    """Static terms (rebatch 256 of 400 queries, dense depth-sampling
    matrix) and the refined BEV."""
    jm, v, tm = models
    from fbbev_tpu.models.fbocc import make_backward_projection
    cam = stages["cam"]
    jterms = make_backward_projection(jm).static_terms(
        jax_cam(cam), num_depth_bins=80, feat_hw=(4, 8))
    tterms = tm.backward_projection.static_terms(torch_cam(cam), 80, (4, 8))
    for k in ("idx", "sel_valid", "oh_k", "count"):
        np.testing.assert_array_equal(tterms[k].numpy(),
                                      np.asarray(jterms[k]))
    for k in ("ref_k", "dsmat"):
        close(tterms[k].numpy(), jterms[k], rel=1e-6)
    # the rebatch runs: 256 of 400 query slots, visible ones first
    sel = tterms["sel_valid"].numpy()
    assert sel.shape == (1, 2, 256) and sel.any() and not sel.all()
    rng = np.random.RandomState(12)
    lss = rng.randn(1, 20, 20, 64).astype(np.float32)
    want = _jax(models, lambda m: m.backward_projection(
        jnp.asarray(stages["ctx"]), jnp.asarray(lss), None,
        jnp.asarray(stages["depth"]), False, static_terms=jterms))
    got = tm.backward_projection(
        torch.from_numpy(stages["ctx"]), torch.from_numpy(lss),
        torch.from_numpy(stages["depth"]), tterms)
    close(got.numpy(), want)


@torch.no_grad()
def test_bev_encoder_and_head_match(models):
    """3D ResNet + FPN3D per level, occupancy logits and labels."""
    jm, v, tm = models
    rng = np.random.RandomState(13)
    fused = rng.randn(1, 20, 20, 8, 128).astype(np.float32)
    jx = _jax(models, lambda m: m.img_bev_encoder_backbone(
        jnp.asarray(fused), False))
    jvox = _jax(models, lambda m: m.img_bev_encoder_neck(jx, False))
    tx = tm.img_bev_encoder_backbone(
        torch.from_numpy(fused).permute(0, 4, 1, 2, 3))
    for a, b in zip(tx, jx):
        close(a.permute(0, 2, 3, 4, 1).numpy(), b)
    tvox = tm.img_bev_encoder_neck(tx)
    for a, b in zip(tvox, jvox):
        close(a.permute(0, 2, 3, 4, 1).numpy(), b)
    want = _jax(models, lambda m: m.occupancy_head(jvox, False))
    got = tm.occupancy_head(tvox, return_labels=False)
    close(got.numpy(), want)
    labels = tm.occupancy_head(tvox).numpy()
    assert labels.shape == (1, 40, 40, 16)
    assert (labels == np.asarray(want).argmax(-1)).mean() >= 0.999


def test_every_conv_has_explicit_symmetric_padding(models):
    """No port convolution pads like flax's asymmetric stride-2 'SAME':
    each pads (k-1)*dilation/2 on both sides, or nothing for 1x1."""
    n = 0
    for name, m in models[2].named_modules():
        if isinstance(m, (tnn.Conv2d, tnn.Conv3d)):
            assert not isinstance(m.padding, str), name
            for k, d, p in zip(m.kernel_size, m.dilation, m.padding):
                assert p == (k - 1) * d // 2, (name, m)
            n += 1
    assert n > 80


def test_upsample_nearest_matches_jax_resize(rng):
    """``jax.image.resize('nearest')`` is PyTorch's 'nearest-exact'; plain
    'nearest' differs at non-integer ratios."""
    x = rng.randn(1, 5, 7, 3).astype(np.float32)
    for hw in ((10, 14), (9, 11)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1,) + hw + (3,),
                                           method="nearest"))
        got = tl.upsample_nearest(torch.from_numpy(x).permute(0, 3, 1, 2),
                                  hw).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(9, 11),
        mode="nearest").permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(plain, want)


@pytest.mark.parametrize("out", [(8, 10, 4), (6, 9, 6)])
def test_resize_trilinear_matches(rng, out):
    """Integer (the FPN3D / occ-head case) and non-integer upsampling."""
    from fbbev_tpu.models.layers import resize_trilinear
    x = rng.randn(1, 4, 5, 2, 3).astype(np.float32)
    want = np.asarray(resize_trilinear(jnp.asarray(x), out))
    got = tl.resize_trilinear(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                              out).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_deconv_flip_matches(rng):
    """The exported ConvTranspose3d weight (with its spatial flip) gives
    the JAX deconvolution's output."""
    from fbbev_tpu.models.layers import Deconv2x2x2
    from fbbev_tpu_torch.weights import _Exporter
    x = rng.randn(1, 3, 4, 2, 6).astype(np.float32)
    k = rng.randn(2, 2, 2, 6, 5).astype(np.float32)
    want = Deconv2x2x2(5).apply({"params": {"kernel": jnp.asarray(k)}},
                                jnp.asarray(x))
    b = _Exporter({"d": {"kernel": k}}, {})
    b.deconv3d("w", ("d",))
    m = tnn.ConvTranspose3d(6, 5, 2, stride=2, bias=False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(b.sd["w.weight"]))
        got = m(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    close(got.permute(0, 2, 3, 4, 1).numpy(), want, rel=1e-6)
