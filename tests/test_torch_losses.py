"""The port's losses against the JAX package's, values and gradients with
respect to the logits (and the depth distribution), float32 on the CPU.

Inputs are numpy-seeded: logits (1, 12, 10, 8, 19) with labels over all
19 classes (0 = void, 18 = free) and 30% of the voxels ignored (255).

Tolerances: loss values 1e-5 relative; gradients 1e-5 of the largest
gradient magnitude (float32 sums over ~1000 voxels in another order).
The hist Lovasz bins the errors at 2048 levels; a float32 rounding
difference could move an error across a bin edge, which moves the loss by
far less than the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.models import depth_net as jdn
from fbbev_tpu.models import losses as jl
from fbbev_tpu.models import occ_head as joh
from fbbev_tpu_torch.models import depth_net as tdn
from fbbev_tpu_torch.models import losses as tl
from fbbev_tpu_torch.models import occ_head as toh

torch.set_num_threads(1)

SHAPE = (1, 12, 10, 8)


def inputs(seed=0, shape=SHAPE, C=19):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, C) * 2.0).astype(np.float32)
    target = rng.randint(0, C, size=shape)
    target = np.where(rng.rand(*shape) < 0.3, 255, target).astype(np.int32)
    return logits, target


def weights(H, W):
    cw = jl.occ_class_weights(19)
    dw = jl.bev_distance_weight(H, W)
    return cw, dw


# name -> (JAX fn, port fn) of (logits, target, class weights, dist weight)
LOSSES = {
    "focal": (lambda lg, t, cw, dw: jl.focal_ce_loss(lg, t, cw, dw),
              lambda lg, t, cw, dw: tl.focal_ce_loss(lg, t, cw, dw)),
    "sem_scal": (lambda lg, t, cw, dw: jl.sem_scal_loss(lg, t),
                 lambda lg, t, cw, dw: tl.sem_scal_loss(lg, t)),
    "geo_scal": (lambda lg, t, cw, dw: jl.geo_scal_loss(lg, t),
                 lambda lg, t, cw, dw: tl.geo_scal_loss(lg, t)),
    "lovasz_hist": (
        lambda lg, t, cw, dw: jl.lovasz_softmax_loss(lg, t, method="hist"),
        lambda lg, t, cw, dw: tl.lovasz_softmax_loss(lg, t, method="hist")),
    "lovasz_sort": (
        lambda lg, t, cw, dw: jl.lovasz_softmax_loss(lg, t, method="sort"),
        lambda lg, t, cw, dw: tl.lovasz_softmax_loss(lg, t, method="sort")),
    "ce_ssc": (lambda lg, t, cw, dw: jl.ce_ssc_loss(lg, t, cw),
               lambda lg, t, cw, dw: tl.ce_ssc_loss(lg, t, cw)),
}


def value_and_grads(name, logits, target):
    jfn, tfn = LOSSES[name]
    cw, dw = weights(*logits.shape[1:3])
    jv, jg = jax.value_and_grad(lambda lg: jfn(
        lg, jnp.asarray(target), jnp.asarray(cw), jnp.asarray(dw)))(
            jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    tv = tfn(lg, torch.from_numpy(target).long(), torch.from_numpy(cw),
             torch.from_numpy(dw))
    (tg,) = torch.autograd.grad(tv, lg)
    return float(jv), np.asarray(jg), float(tv), tg.numpy()


def assert_grads_close(got, want):
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_and_grad_match_jax(name):
    logits, target = inputs()
    jv, jg, tv, tg = value_and_grads(name, logits, target)
    assert np.isfinite(tv) and tv != 0.0
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    assert np.abs(jg).max() > 0
    assert_grads_close(tg, jg)


def test_lovasz_hist_within_a_bin_of_sort():
    """The hist form equals the exact Lovasz of the quantised errors, so
    it lies within one bin width (1/2047) of the sort form."""
    logits, target = inputs(1)
    lg, t = torch.from_numpy(logits), torch.from_numpy(target).long()
    hist = float(tl.lovasz_softmax_loss(lg, t, method="hist"))
    exact = float(tl.lovasz_softmax_loss(lg, t, method="sort"))
    assert abs(hist - exact) <= 1.0 / 2047


def test_class_and_distance_weights_match():
    from fbbev_tpu.models.losses import bev_distance_weight
    np.testing.assert_array_equal(tl.occ_class_weights(19),
                                  jl.occ_class_weights(19))
    np.testing.assert_array_equal(tl.occ_class_weights(18),
                                  jl.occ_class_weights(18))
    np.testing.assert_array_equal(tl.bev_distance_weight(40, 30),
                                  bev_distance_weight(40, 30))


@pytest.mark.parametrize("ratio", [1, 2], ids=["full_res", "mode_pooled"])
def test_occ_losses_match_jax(ratio):
    """The four voxel losses as the trainer sums them, with the GT at the
    logits' resolution and at twice it (mode-pooled first), gradients of
    their sum included.  The hist Lovasz as the default."""
    logits, _ = inputs(2)
    rng = np.random.RandomState(3)
    gshape = tuple(s * ratio for s in SHAPE[1:])
    target = rng.randint(0, 19, size=(1,) + gshape)
    target = np.where(rng.rand(1, *gshape) < 0.2, 255, target)
    target = np.where(rng.rand(1, *gshape) < 0.3, 18, target).astype(
        np.int32)
    cw, dw = weights(*SHAPE[1:3])

    def jax_total(lg):
        out = joh.occ_losses(lg, jnp.asarray(target), jnp.asarray(cw),
                             jnp.asarray(dw))
        return sum(out.values()), out

    (jv, jout), jg = jax.value_and_grad(jax_total, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    tout = toh.occ_losses(lg, torch.from_numpy(target),
                          torch.from_numpy(cw), torch.from_numpy(dw))
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]),
                                   rtol=1e-5, err_msg=k)
    (tg,) = torch.autograd.grad(sum(tout.values()), lg)
    assert_grads_close(tg.numpy(), np.asarray(jg))


def test_downsample_gt_mode_pool_matches_jax():
    """Mode pooling with the reference's quirks: all-empty-sum blocks,
    uniquified zeros, distinct labels -> 255, smallest-value ties."""
    rng = np.random.RandomState(4)
    t = rng.choice([0, 1, 5, 18, 255], size=(2, 8, 6, 4),
                   p=[0.2, 0.2, 0.2, 0.3, 0.1])
    t[0, :2, :2, :2] = 0
    t[0, :2, :2, 0] = 18                      # sum == 18: raw mode
    t[1, :2, :2, :2] = np.array([0, 1, 2, 3, 4, 5, 6, 7]).reshape(2, 2, 2)
    want = np.asarray(joh.downsample_gt_mode_pool(jnp.asarray(t), 2))
    got = toh.downsample_gt_mode_pool(torch.from_numpy(t), 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 255).any()


def test_depth_loss_and_grad_match_jax():
    """BCE of the depth distribution against the min-pooled one-hot GT
    (zeros as background), gradient with respect to the distribution."""
    rng = np.random.RandomState(5)
    d = rng.rand(1, 2, 80, 4, 8).astype(np.float32)
    d = d / d.sum(2, keepdims=True)
    gt = rng.rand(1, 2, 64, 128).astype(np.float32) * 50.0
    gt = np.where(rng.rand(1, 2, 64, 128) < 0.9, 0.0, gt).astype(np.float32)
    bounds = (2.0, 42.0, 0.5)
    jv, jg = jax.value_and_grad(lambda x: jdn.depth_loss(
        jnp.asarray(gt), x, 16, bounds))(jnp.asarray(d))
    x = torch.from_numpy(d).requires_grad_()
    tv = tdn.depth_loss(torch.from_numpy(gt), x, 16, bounds)
    (tg,) = torch.autograd.grad(tv, x)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    assert_grads_close(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(
        tdn.downsample_gt_depth(torch.from_numpy(gt), 16, bounds,
                                80).numpy(),
        np.asarray(jdn.downsample_gt_depth(jnp.asarray(gt), 16, bounds, 80)))
