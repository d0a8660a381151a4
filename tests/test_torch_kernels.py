"""Plain versions of the port's kernels against the JAX package's TPU
kernels, run through the Pallas interpreter on CPU.

* K2 (voxel pool) vs ``pallas_pool.lss_voxel_pool_planned``; plus the
  CUDA kernel's walk over its row tiles, emulated in numpy.
* K3 (deformable sampling) vs ``pallas_sample.deformable_sample_attend_
  pallas``, f32 and bf16 value maps, and vs mmcv's ``grid_sample``
  formulation.
* K1 (fused history warp) vs ``pallas_fuse_warp.fuse_warp``, with and
  without the conv epilogue, over a stream with a mid-stream sequence
  start and small ego motion inside the TPU kernel's locality contract.
* K7 (3x3 conv) vs ``pallas_conv.conv3x3_s1`` at the shapes of
  ``tests/test_pallas_conv.py``, and its custom backward vs ``jax.grad``
  of ``pallas_conv.conv3x3``.
* K7's z-slab route of the 3x3x3 convs (``Conv3dZSlabK7``) vs the JAX
  package's ``Conv3DZSlab``, forward and gradients.
* K10 (deformable sampling from precomputed corners) vs ``pallas_deform.
  pallas_deformable_sample_attend``, f32 and bf16 value maps, and its
  corner entry's plain version vs K3's.
* The wrappers of K1-K3, K5, K6, K8-K10 and K7's forward refuse inputs
  that require grad.

Tolerances are float32 rounding of differently ordered sums (stated per
test); the bf16 cases allow the bf16 rounding of the tent weights both
sides apply.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from fbbev_tpu.ops import pallas_conv as jconv
from fbbev_tpu.ops import pallas_deform as jdeform
from fbbev_tpu.ops import pallas_fuse_warp as jfw
from fbbev_tpu.ops import pallas_pool as jpool
from fbbev_tpu.ops import pallas_sample as jsample
from fbbev_tpu_torch import geometry as tgeo
from fbbev_tpu_torch.ops import deform_attn as tda
from fbbev_tpu_torch.ops import pallas_conv as K7
from fbbev_tpu_torch.ops import pallas_conv3d as K6
from fbbev_tpu_torch.ops import pallas_deform as K10
from fbbev_tpu_torch.ops import pallas_fuse_warp as K1
from fbbev_tpu_torch.ops import pallas_occ_fuse as K9
from fbbev_tpu_torch.ops import pallas_occ_tail as K8
from fbbev_tpu_torch.ops import pallas_pool as K2
from fbbev_tpu_torch.ops import pallas_sample as K3
from fbbev_tpu_torch.ops import pallas_warp as K5

from tests.test_torch_pool_deform import emulate_k2
from tests.test_torch_slice import flow

torch.set_num_threads(1)


# ---------------------------------------------------------------- K2
def _random_ranks(rng, B, N, D, fH, fW, grid_size, valid_frac=0.6):
    nx, ny, nz = grid_size
    P = B * N * D * fH * fW
    per = nx * ny * nz
    ranks = (np.arange(P) // (P // B)) * per + rng.randint(0, per, size=P)
    return np.where(rng.rand(P) > valid_frac, B * per, ranks).astype(
        np.int32)


@pytest.mark.parametrize("B,N", [(1, 2), (2, 3)])
def test_k2_plain_matches_pallas_pool(rng, B, N):
    """Plain pool and the numpy walk of the kernel's row tiles vs the
    interpreted TPU kernel (1e-5)."""
    D, fH, fW, C = 5, 4, 8, 24
    grid_size = (12, 10, 4)
    ranks = _random_ranks(rng, B, N, D, fH, fW, grid_size)
    depth = rng.rand(B, N, D, fH, fW).astype(np.float32)
    feat = rng.randn(B, N, fH, fW, C).astype(np.float32)
    want = np.asarray(jpool.lss_voxel_pool_planned(
        jpool.plan_pool(ranks, B, N, D, fH, fW, grid_size, K=64, R=64),
        jnp.asarray(depth), jnp.asarray(feat), interpret=True))

    plan = K2.plan_pool(ranks, B, N, D, fH, fW, grid_size)
    got = K2.lss_voxel_pool_planned(plan, torch.from_numpy(depth),
                                    torch.from_numpy(feat)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # the CUDA kernel's walk over the plan's row tiles: every output row
    # written once, empty rows with zeros
    out = emulate_k2(plan, depth, feat)
    assert not np.isnan(out).any()
    assert plan.pts.numel() == (ranks < B * 480).sum()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- K3
def _k3_inputs(rng, B, H, W, heads, hd, Q, P):
    v = rng.randn(B, H * W, heads, hd).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Q, heads, P, 2)).astype(np.float32)
    a = rng.randn(B, Q, heads, P).astype(np.float32)
    a = np.exp(a) / np.exp(a).sum(-1, keepdims=True)
    return v, loc, a.astype(np.float32)


def test_k3_plain_matches_pallas_sample(rng):
    """f32 value map: 1e-5."""
    B, H, W, heads, hd, Q, P = 2, 16, 44, 8, 10, 64, 8
    v, loc, a = _k3_inputs(rng, B, H, W, heads, hd, Q, P)
    want = np.asarray(jsample.deformable_sample_attend_pallas(
        jnp.asarray(v), (H, W), jnp.asarray(loc), jnp.asarray(a),
        interpret=True))
    got = K3.deformable_sample_attend(
        torch.from_numpy(v), (H, W), torch.from_numpy(loc),
        torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and mmcv's grid_sample formulation of the same function
    mm = tda.multi_scale_deformable_attention(
        torch.from_numpy(v), [(H, W)], torch.from_numpy(loc)[:, :, :, None],
        torch.from_numpy(a)[:, :, :, None]).numpy()
    np.testing.assert_allclose(got, mm, rtol=1e-5, atol=1e-5)


def test_k3_plain_bf16_value_matches_pallas_sample(rng):
    """bf16 value map: both round the weight tent*attn to bf16 and sum in
    f32, so they agree to f32 rounding (1e-5)."""
    B, H, W, heads, hd, Q, P = 1, 8, 16, 4, 16, 32, 4
    v, loc, a = _k3_inputs(rng, B, H, W, heads, hd, Q, P)
    want = np.asarray(jsample.deformable_sample_attend_pallas(
        jnp.asarray(v).astype(jnp.bfloat16), (H, W), jnp.asarray(loc),
        jnp.asarray(a), interpret=True))
    got = K3.deformable_sample_attend(
        torch.from_numpy(v).to(torch.bfloat16), (H, W),
        torch.from_numpy(loc), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- K10
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k10_matches_pallas_deform(rng, dtype):
    """The drop-in vs the TPU kernel in interpret mode, locations from
    -0.1 to 1.1 and a Q (37) that is not a multiple of its ``tile_q``
    (16), as ``test_deform_attn.py::test_pallas_kernel_matches_xla``.
    Both round each corner weight to the value type and sum exact
    products in f32: they agree to f32 rounding (1e-5), in bf16 too
    (tighter than one bf16 rounding of the output)."""
    B, H, W, heads, hd, Q, P = 2, 6, 9, 4, 8, 37, 4
    v, loc, a = _k3_inputs(rng, B, H, W, heads, hd, Q, P)
    jv = jnp.asarray(v).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    want = np.asarray(jdeform.pallas_deformable_sample_attend(
        jv, (H, W), jnp.asarray(loc), jnp.asarray(a), interpret=True))
    before = K10.launches
    got = K10.pallas_deformable_sample_attend(
        torch.from_numpy(v).to(dtype), (H, W), torch.from_numpy(loc),
        torch.from_numpy(a))
    assert K10.launches == before        # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (B, Q, heads * hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k10_corners_plain_matches_k3_plain(rng, dtype):
    """The corner entry's plain version on :func:`pallas_deform.corners`
    vs K3's plain version on the same locations: the same rounded weights
    and exact products, summed in another order (1e-5)."""
    B, H, W, heads, hd, Q, P = 2, 16, 44, 8, 10, 50, 8
    v, loc, a = _k3_inputs(rng, B, H, W, heads, hd, Q, P)
    value = torch.from_numpy(v).to(dtype)
    loc, a = torch.from_numpy(loc), torch.from_numpy(a)
    idx, wgt = K10.corners(loc, a, H, W)
    assert idx.dtype == torch.int32 and wgt.dtype == torch.float32
    assert idx.shape == wgt.shape == (B, Q * heads * P, 4)
    assert int(idx.min()) >= 0 and int(idx.max()) < H * W
    got = K10.deformable_sample_attend_corners(value, idx, wgt, heads, P)
    want = tda.deformable_sample_attend(value, (H, W), loc, a)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_bilinear_sample_matrix_matches(rng):
    from fbbev_tpu.ops.deform_attn import bilinear_sample_matrix
    loc = rng.uniform(-0.2, 1.2, (2, 3, 50, 2)).astype(np.float32)
    want = np.asarray(bilinear_sample_matrix(jnp.asarray(loc), (4, 8)))
    got = tda.bilinear_sample_matrix(torch.from_numpy(loc), (4, 8)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- K1
def _k1_stream(rng, epilogue, dtype):
    """Yields (jax args, torch args) over a 6-step stream: starts at
    steps 0 and 3, ego motion flow(step) otherwise, the oldest slot
    rotating through the ring."""
    B, Z, Y, X, C, T, F = 1, 8, 20, 20, 64, 2, 128
    dx, bx, _ = tgeo.gen_dx_bx((-40, 40, 4.0), (-40, 40, 4.0),
                               (-1, 5.4, 0.8))
    f2b = torch.from_numpy(tgeo.feat2bev_matrix(dx, bx))
    eye = torch.eye(4)[None]
    hist = rng.randn(B, Z, Y, X, T * C).astype(np.float32)
    for step in range(6):
        start = step in (0, 3)
        mat = (eye if start else tgeo.flow_matrix_from_grid_args(
            eye, eye, torch.from_numpy(flow(step)), f2b))
        curr = rng.randn(B, Y, X, Z, C).astype(np.float32)
        args = dict(hist=hist, curr=curr, mat=mat.numpy(),
                    start=np.array([start]),
                    hsel=np.array([step % T], np.int32))
        epi = None
        if epilogue:
            epi = dict(kc=rng.randn(C, C) / 8.0, ke=rng.randn(C) * 0.1,
                       kb=rng.randn(C) * 0.1, tvec=rng.rand(B, T) * 4.0,
                       ws=rng.randn(B, T * C, F) / np.sqrt(T * C))
            epi = {k: np.asarray(e, np.float32) for k, e in epi.items()}
        yield args, epi
        # the stream carries the new history the JAX kernel produced
        hist = np.asarray(jfw.fuse_warp(
            jnp.asarray(hist).astype(dtype), jnp.asarray(curr).astype(dtype),
            jnp.asarray(args["mat"]), jnp.asarray(args["start"]),
            jnp.asarray(args["hsel"]), interpret=True)[1]).astype(np.float32)


@pytest.mark.parametrize("epilogue", [False, True])
def test_k1_plain_matches_fuse_warp_stream(epilogue):
    """f32: warped slots / new history to 1e-5 (the tent weights are
    computed in slab-relative coordinates by the TPU kernel and absolute
    ones here, a float32 rounding difference); epilogue output to 1e-4
    relative to its largest value (two more float32 products)."""
    rng = np.random.RandomState(7)
    for a, epi in _k1_stream(rng, epilogue, jnp.float32):
        jargs = [jnp.asarray(a[k]) for k in
                 ("hist", "curr", "mat", "start", "hsel")]
        want, want_h = jfw.fuse_warp(
            *jargs, interpret=True,
            epilogue=None if epi is None else
            {k: jnp.asarray(e) for k, e in epi.items()})
        got, got_h = K1.fuse_warp(
            *[torch.from_numpy(a[k]) for k in
              ("hist", "curr", "mat", "start", "hsel")],
            epilogue=None if epi is None else
            {k: torch.from_numpy(e) for k, e in epi.items()})
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   rtol=1e-5, atol=1e-5)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_k1_plain_bf16_history_matches_fuse_warp():
    """bf16 history: both round the tent weights, the warped slot and y1
    to bf16 (pallas_fuse_warp.py:234-263).  A different f32 rounding of a
    sum may still move a value across a bf16 boundary, so the new history
    may differ by one bf16 ulp on a few elements and the epilogue output
    by 1e-2 relative to its largest value."""
    rng = np.random.RandomState(8)
    for a, epi in _k1_stream(rng, True, jnp.bfloat16):
        want, want_h = jfw.fuse_warp(
            jnp.asarray(a["hist"]).astype(jnp.bfloat16),
            jnp.asarray(a["curr"]).astype(jnp.bfloat16),
            jnp.asarray(a["mat"]), jnp.asarray(a["start"]),
            jnp.asarray(a["hsel"]), interpret=True,
            epilogue={k: jnp.asarray(e) for k, e in epi.items()})
        got, got_h = K1.fuse_warp(
            torch.from_numpy(a["hist"]).to(torch.bfloat16),
            torch.from_numpy(a["curr"]).to(torch.bfloat16),
            torch.from_numpy(a["mat"]), torch.from_numpy(a["start"]),
            torch.from_numpy(a["hsel"]),
            epilogue={k: torch.from_numpy(e) for k, e in epi.items()})
        wh = np.asarray(want_h.astype(jnp.float32))
        d = np.abs(got_h.float().numpy() - wh)
        assert (d > 0).mean() < 1e-3
        assert (d <= 2.0 ** -7 * np.maximum(np.abs(wh), 1e-3)).all()
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()


# ---------------------------------------------------------------- K7
def _k7_inputs(rng, B, H, W, Cin, Cout):
    """NHWC / HWIO numpy inputs as test_pallas_conv.py makes them."""
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    w = (rng.randn(3, 3, Cin, Cout) * 0.05).astype(np.float32)
    return x, w


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _oihw(w):
    return torch.from_numpy(w).permute(3, 2, 0, 1)


@pytest.mark.parametrize("B,H,W,Cin,Cout", [
    (1, 16, 16, 64, 64),
    (2, 20, 28, 64, 128),
    (3, 8, 24, 128, 64),
])
def test_k7_plain_matches_pallas_conv(B, H, W, Cin, Cout):
    """f32: 1e-5 (sums of 9*Cin products in another order; outputs O(1)).
    The module's gate agrees with the JAX one at these shapes."""
    x, w = _k7_inputs(np.random.RandomState(0), B, H, W, Cin, Cout)
    want = np.asarray(jconv.conv3x3_s1(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True))
    got = K7.conv3x3_s1(_nchw(x), _oihw(w)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert K7.supports((B, Cin, H, W), Cout) == jconv.supports(
        (B, H, W, Cin), (3, 3), (1, 1), "SAME", (1, 1))


def test_k7_plain_bf16_matches_pallas_conv():
    """bf16 in and out, f32 accumulation on both sides: each output is the
    same f32 sum rounded once to bf16, so an element may differ by one
    bf16 ulp (2^-7 of its magnitude) where the sums round differently, on
    under 1% of them."""
    x, w = _k7_inputs(np.random.RandomState(1), 1, 16, 16, 64, 64)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(jconv.conv3x3_s1(xb, wb, interpret=True).astype(
        jnp.float32))
    got = K7.conv3x3_s1(_nchw(x).to(torch.bfloat16),
                        _oihw(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    d = np.abs(got.permute(0, 2, 3, 1).float().numpy() - want)
    assert (d <= 2.0 ** -7 * np.maximum(np.abs(want), 1e-3)).all()
    assert (d > 0).mean() < 1e-2


def test_k7_custom_backward_matches_jax_grad():
    """``Conv3x3``'s backward (dgrad on the kernel's plain version, wgrad
    as nine f32 contractions) vs ``jax.grad`` of the TPU kernel's custom
    VJP, to test_pallas_conv.py's tolerances (1e-3; wgrad atol 1e-2)."""
    rng = np.random.RandomState(2)
    x, w = _k7_inputs(rng, 2, 12, 16, 64, 64)

    def loss(x, w):
        return jnp.sum(jconv.conv3x3(x, w) ** 2)

    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w))
    xt = _nchw(x).requires_grad_()
    wt = _oihw(w).requires_grad_()
    y = K7.conv3x3(xt, wt)
    gx_t, gw_t = torch.autograd.grad((y ** 2).sum(), (xt, wt))
    np.testing.assert_allclose(gx_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_j), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(gw_t.permute(2, 3, 1, 0).numpy(),
                               np.asarray(gw_j), rtol=1e-3, atol=1e-2)


def test_k7_module_routes_by_the_gate():
    """``Conv3x3K7`` runs K7 (its autograd node) where the gate holds --
    Cin % 64 == 0, H >= 4, W >= 8 -- and ``nn.Conv2d`` elsewhere, with
    the same output."""
    from fbbev_tpu_torch.models.layers import conv
    torch.manual_seed(0)
    for cin, hw, routed in ((64, (8, 16), True), (32, (8, 16), False),
                            (64, (2, 16), False)):
        m = conv(2, cin, 32, 3, 1, 1, pallas3x3=True)
        x = torch.randn(2, cin, *hw, requires_grad=True)
        y = m(x)
        assert (type(y.grad_fn).__name__.startswith("Conv3x3")) == routed
        want = torch.nn.functional.conv2d(x, m.weight, padding=1)
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,yxz,routed", [
    (64, (8, 12, 3), True), (32, (8, 12, 3), False), (64, (8, 6, 3), False),
])
def test_k7_zslab_module_routes_by_the_gate(monkeypatch, cin, yxz, routed):
    """``Conv3dZSlabK7`` sends its three z-slabs through K7 where the gate
    holds for a (B*Z, Cin, Y, X) slab -- Cin % 64 == 0, Y >= 4, X >= 8,
    as ``_pallas3x3_eligible`` on the JAX z-slab -- and is ``nn.Conv3d``
    elsewhere, with the same output and gradients (f32, 1e-4)."""
    from fbbev_tpu_torch.models.layers import Conv3dZSlabK7, conv
    calls = []
    real = K7.conv3x3
    monkeypatch.setattr(K7, "conv3x3",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    torch.manual_seed(0)
    m = conv(3, cin, 32, 3, 1, 1, bias=True, pallas3x3=True)
    assert isinstance(m, Conv3dZSlabK7)
    x = torch.randn(2, cin, *yxz, requires_grad=True)
    y = m(x)
    Y, X, Z = yxz
    assert calls == ([(2 * Z, cin, Y, X)] * 3 if routed else [])
    want = torch.nn.functional.conv3d(x, m.weight, m.bias, padding=1)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    gy = torch.randn_like(want)
    got = torch.autograd.grad(y, (x, m.weight, m.bias), gy)
    ref = torch.autograd.grad(want, (x, m.weight, m.bias), gy)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_k7_zslab_matches_jax_conv3d_zslab():
    """``Conv3dZSlabK7`` on K7's plain version vs the JAX package's
    ``Conv3DZSlab`` (f32, the same three z-shifted 2D convs summed):
    forward 1e-5 (sums of 9*Cin products in another order, O(1)
    outputs); input and weight gradients of sum(y^2) to
    test_pallas_conv.py's tolerances (1e-3; weight atol 1e-2)."""
    from fbbev_tpu.models.layers import Conv3DZSlab
    from fbbev_tpu_torch.models.layers import Conv3dZSlabK7
    rng = np.random.RandomState(3)
    B, Y, X, Z, Cin, Cout = 1, 8, 12, 3, 64, 32
    x = rng.randn(B, Y, X, Z, Cin).astype(np.float32)
    k = (rng.randn(3, 3, 3, Cin, Cout) / np.sqrt(27 * Cin)).astype(
        np.float32)
    b = (rng.randn(Cout) * 0.1).astype(np.float32)
    jm = Conv3DZSlab(Cout, use_bias=True)

    def loss(x, k, b):
        return jnp.sum(jm.apply({"params": {"kernel": k, "bias": b}},
                                x) ** 2)

    y_j = np.asarray(jm.apply({"params": {"kernel": jnp.asarray(k),
                                          "bias": jnp.asarray(b)}},
                              jnp.asarray(x)))
    gx_j, gk_j = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    m = Conv3dZSlabK7(Cin, Cout, 3, padding=1, bias=True)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(k).permute(4, 3, 0, 1, 2))
        m.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
    y = m(xt)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 4, 1).numpy(),
                               y_j, rtol=1e-5, atol=1e-5)
    gx, gw = torch.autograd.grad((y ** 2).sum(), (xt, m.weight))
    np.testing.assert_allclose(gx.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(gx_j), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(gw.permute(2, 3, 4, 1, 0).numpy(),
                               np.asarray(gk_j), rtol=1e-3, atol=1e-2)


def _requires_grad_calls():
    """(name, call) of every wrapper of a kernel without a backward, with
    one input that requires grad."""
    g = torch.randn(1, 8, 2, 4, requires_grad=True)
    plan = K2.plan_pool(np.zeros(1 * 2 * 3 * 2 * 4, np.int32), 1, 2, 3, 2,
                        4, (4, 4, 2))
    mat = torch.eye(4)[None]
    return [
        ("K1", lambda: K1.fuse_warp(
            torch.randn(1, 2, 4, 4, 16), torch.randn(1, 4, 4, 2, 8,
                                                     requires_grad=True),
            mat, torch.tensor([False]), torch.tensor([0]))),
        ("K2", lambda: K2.lss_voxel_pool_planned(
            plan, torch.rand(1, 2, 3, 2, 4, requires_grad=True),
            torch.randn(1, 2, 2, 4, 8))),
        ("K3", lambda: K3.deformable_sample_attend(
            torch.randn(1, 8, 2, 4), (2, 4), torch.rand(1, 3, 2, 2, 2),
            torch.rand(1, 3, 2, 2, requires_grad=True))),
        ("K7", lambda: K7.conv3x3_s1(g, torch.randn(8, 8, 3, 3))),
        ("K5", lambda: K5.warp_affine_3d(
            torch.randn(1, 2, 4, 4, 8, requires_grad=True), mat)),
        ("K6", lambda: K6.conv3d_3x3x3(
            torch.randn(1, 16, 4, 4, 2),
            torch.randn(16, 16, 3, 3, 3, requires_grad=True))),
        ("K8", lambda: K8.occ_tail(
            [torch.randn(1, 4, 2, 2, 2), torch.randn(1, 4, 1, 1, 1)],
            torch.rand(1, 2, 2, 2, 2, requires_grad=True), torch.ones(4),
            torch.zeros(4), torch.randn(4, 3))),
        ("K9", lambda: K9.fuse_multiscale(
            [torch.randn(1, 4, 2, 2, 2, requires_grad=True),
             torch.randn(1, 4, 1, 1, 1)], torch.rand(1, 2, 2, 2, 2))),
        ("K10", lambda: K10.pallas_deformable_sample_attend(
            torch.randn(1, 8, 2, 4), (2, 4), torch.rand(1, 3, 2, 2, 2),
            torch.rand(1, 3, 2, 2, requires_grad=True))),
    ]


@pytest.mark.parametrize("which", ["K1", "K2", "K3", "K5", "K6", "K7", "K8",
                                   "K9", "K10"])
def test_wrappers_refuse_inputs_that_require_grad(which):
    """A kernel without a backward would return a tensor with no
    ``grad_fn`` and cut the graph silently: the wrapper raises instead,
    and runs under ``torch.no_grad()``."""
    call = dict(_requires_grad_calls())[which]
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        call()
