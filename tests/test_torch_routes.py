"""The port's kernel-routed eval configurations against the JAX package, on
the CPU in float32 (bf16 where stated): the plain versions of K5 (warp),
K6 (3x3x3 conv), K8 (occ tail) and K9 (occ blend) against the TPU kernels
in interpret mode, each route at module level where its gate holds, and
the small serving stream with ``fuse_warp=False, pallas_conv3d=True,
occ_tail=True`` against the JAX ``FixedRigPipeline`` under
``FBBEV_FUSE_WARP=0``, ``FBBEV_OCC_TAIL=1`` and ``FBBEV_CONV3D=pallas``.

Each module test mirrors the JAX package's own kernel test
(``test_pallas_warp.py``, ``test_pallas_conv3d.py``,
``test_pallas_occ_tail.py``, ``test_pallas_occ_fuse.py``) and keeps its
tolerance unless stated.  Routed calls are counted on both sides: the JAX
side counts the kernels its (jitted) graphs trace, the port its wrapper
calls.  bf16 comparisons with JAX allow a few bf16 roundings: XLA on the
CPU may keep excess precision between bf16 ops where the port rounds each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.models import layers as jlayers
from fbbev_tpu.models.occ_head import OccHead as JaxOccHead
from fbbev_tpu.ops import pallas_conv3d as jconv3d
from fbbev_tpu.ops import pallas_occ_fuse as jfuse
from fbbev_tpu.ops import pallas_occ_tail as jtail
from fbbev_tpu.ops import pallas_warp as jwarp
from fbbev_tpu_torch import weights
from fbbev_tpu_torch.models import FBOCC
from fbbev_tpu_torch.models.layers import Conv3dK6, conv_bn_relu, \
    upsample_int_axis
from fbbev_tpu_torch.models.occ_head import OccHead
from fbbev_tpu_torch.ops import pallas_conv3d as K6
from fbbev_tpu_torch.ops import pallas_occ_fuse as K9
from fbbev_tpu_torch.ops import pallas_occ_tail as K8
from fbbev_tpu_torch.ops import pallas_warp as K5
from fbbev_tpu_torch.weights import load_jax_variables

from tests.test_torch_slice import (SMALL, assert_off_voxel_faces, flow,
                                    jax_cam, models, rig, torch_cam)

torch.set_num_threads(1)

BF16 = torch.bfloat16
assert models  # the module-scoped fixture of the small model


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _count(monkeypatch, mod, fn, calls, key):
    """Count the calls of ``mod.fn`` under ``calls[key]``."""
    real = getattr(mod, fn)

    def wrapped(*a, **k):
        calls[key] = calls.get(key, 0) + 1
        return real(*a, **k)

    monkeypatch.setattr(mod, fn, wrapped)


def _filled(shapes, seed):
    """numpy-seeded values for a flax variables shape tree: random BN
    statistics, scales and biases, LeCun-scaled kernels."""
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
        else:
            v = rng.randn(*shape) * 0.1
        return jnp.asarray(np.asarray(v, np.float32))

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


# ---------------------------------------------------------------- K5
def _flow(theta_deg, tx, ty, tz=0.0, pitch=0.0):
    th = np.deg2rad(theta_deg)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = (np.cos(th), -np.sin(th),
                                          np.sin(th), np.cos(th))
    m[0, 3], m[1, 3], m[2, 3] = tx, ty, tz
    m[2, 0] = pitch
    return m[None]


@pytest.mark.parametrize("theta,tx,ty,tz,pitch", [
    (0.0, 0.0, 0.0, 0.0, 0.0),
    (5.0, 3.7, -2.2, 0.3, 0.01),
    (-17.0, -6.0, 4.0, -0.4, -0.02),
    (30.0, 0.5, 0.5, 0.0, 0.0),
    (0.0, 120.0, 0.0, 0.0, 0.0),   # everything out of volume -> zeros
])
def test_k5_plain_matches_pallas_warp(theta, tx, ty, tz, pitch):
    """f32, the out_zyx=False layout, inside the TPU kernel's locality
    contract: 1e-4 (``test_pallas_warp.py``'s tolerance)."""
    vol = np.random.RandomState(0).randn(1, 8, 40, 40, 128).astype(
        np.float32)
    mat = _flow(theta, tx, ty, tz, pitch)
    want = np.asarray(jwarp.warp_affine_3d(jnp.asarray(vol),
                                           jnp.asarray(mat), out_zyx=False,
                                           interpret=True))
    got = K5.warp_affine_3d(_t(vol), _t(mat)).numpy()
    assert got.shape == want.shape == (1, 40, 40, 8, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_k5_plain_bf16_matches_pallas_warp():
    """bf16 volume: the TPU kernel rounds each tent weight to bf16, the
    plain version (the XLA fallback's f32 weights) does not; both round the
    result once: within 2^-7 of the volume's largest magnitude."""
    vol = np.random.RandomState(1).randn(1, 8, 40, 40, 128).astype(
        np.float32)
    mat = _flow(5.0, 3.7, -2.2, 0.3, 0.01)
    want = np.asarray(jwarp.warp_affine_3d(
        jnp.asarray(vol, jnp.bfloat16), jnp.asarray(mat), out_zyx=False,
        interpret=True).astype(jnp.float32))
    got = K5.warp_affine_3d(_t(vol, BF16), _t(mat))
    assert got.dtype == BF16
    assert np.abs(got.float().numpy() - want).max() <= (
        2.0 ** -7 * np.abs(vol).max())


@pytest.mark.parametrize("shape", [
    (1, 8, 100, 100, 1280), (1, 8, 25, 25, 1280), (1, 8, 100, 100, 80),
    (1, 2, 100, 100, 128), (1, 8, 20, 20, 128), (1, 8, 40, 40, 128)])
def test_k5_gate_matches_jax(shape):
    assert K5.supports(shape) == jwarp.supports(shape)


# ---------------------------------------------------------------- K6
def _ncdhw(x):
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _oidhw(k):
    return torch.from_numpy(k).permute(4, 3, 0, 1, 2)


@pytest.mark.parametrize("shape,cout", [
    ((2, 8, 10, 4, 64), 64),
    ((1, 10, 8, 2, 128), 128),
    ((1, 5, 5, 8, 64), 128),
])
def test_k6_plain_matches_pallas_conv3d(shape, cout):
    """f32: 1e-4 (``test_pallas_conv3d.py``'s tolerance; sums of 27*Cin
    products in another order)."""
    rng = np.random.RandomState(0)
    assert K6.supports(shape, cout) and jconv3d.supports(shape, cout)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 3, shape[-1], cout) * 0.05).astype(np.float32)
    want = np.asarray(jconv3d.conv3d_3x3x3(jnp.asarray(x), jnp.asarray(k),
                                           interpret=True))
    got = K6.conv3d_3x3x3(_ncdhw(x), _oidhw(k)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_k6_plain_bf16_matches_pallas_conv3d():
    """bf16 in and out, f32 accumulation on both sides: each output is the
    same f32 sum rounded once to bf16, so an element may differ by one
    bf16 ulp (2^-7 of its magnitude) where the sums round differently, on
    under 2% of them."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 8, 8, 4, 64).astype(np.float32)
    k = (rng.randn(3, 3, 3, 64, 64) * 0.05).astype(np.float32)
    want = np.asarray(jconv3d.conv3d_3x3x3(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        interpret=True).astype(jnp.float32))
    got = K6.conv3d_3x3x3(_ncdhw(x).to(BF16), _oidhw(k).to(BF16))
    assert got.dtype == BF16
    d = np.abs(got.permute(0, 2, 3, 4, 1).float().numpy() - want)
    assert (d <= 2.0 ** -7 * np.maximum(np.abs(want), 1e-2)).all()
    assert (d > 0).mean() < 2e-2


@pytest.mark.parametrize("shape,cout", [
    ((1, 7, 7, 4, 64), 64), ((1, 8, 8, 4, 80), 64), ((1, 8, 8, 4, 64), 19),
    ((1, 8, 8, 1, 64), 64), ((1, 100, 100, 8, 256), 256),
    ((1, 25, 25, 2, 256), 256), ((1, 5, 5, 2, 64), 64),
    ((1, 50, 50, 4, 256), 128), ((1, 20, 20, 8, 32), 32)])
def test_k6_gate_matches_jax(shape, cout):
    assert K6.supports(shape, cout) == jconv3d.supports(shape, cout)


def test_k6_module_routes_as_convbn(monkeypatch):
    """``conv_bn_relu(..., pallas_conv3d=True)`` (a :class:`Conv3dK6`) vs
    the JAX ``ConvBN`` with its 3D Pallas route on (``_PALLAS_CONV3D``,
    interpret hook): in eval each sends the conv through its kernel once,
    and the outputs agree to 1e-4; in train mode neither routes
    (``_pallas3d_eligible`` is eval-only)."""
    monkeypatch.setattr(jlayers, "_PALLAS_CONV3D", True)
    monkeypatch.setenv("FBBEV_FORCE_PALLAS_CONV3D", "interpret")
    calls = {}
    _count(monkeypatch, jconv3d, "conv3d_3x3x3", calls, "jax")
    _count(monkeypatch, K6, "conv3d_3x3x3", calls, "port")
    x = np.random.RandomState(2).randn(1, 8, 8, 4, 64).astype(np.float32)
    mod = jlayers.ConvBN(64, 3, padding=1, ndim=3, use_bias=True)
    v = _filled(jax.eval_shape(lambda k, x: mod.init(k, x, True),
                               jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    want = np.asarray(mod.apply(v, jnp.asarray(x), False))
    assert calls == {"jax": 1}
    m = conv_bn_relu(3, 64, 64, 3, 1, 1, bias=True, pallas_conv3d=True)
    assert isinstance(m[0], Conv3dK6)
    b = weights._Exporter(v["params"], v["batch_stats"])
    b.convbn("0", "1", (), ndim=3)
    m.load_state_dict({k: torch.from_numpy(a) for k, a in b.sd.items()},
                      strict=False)
    m.eval()
    with torch.no_grad():
        got = m(_ncdhw(x)).permute(0, 2, 3, 4, 1).numpy()
    assert calls == {"jax": 1, "port": 1}
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    m.train()
    m(_ncdhw(x))
    mod.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    assert calls == {"jax": 1, "port": 1}


# K6's convs in one flagship frame: (count, Y, X, Z, Cin, Cout), as
# ``chip_smoke.py::K6_SHAPES``
K6_SHAPES = [(4, 100, 100, 8, 64, 64), (3, 50, 50, 4, 128, 128),
             (3, 25, 25, 2, 256, 256), (1, 100, 100, 8, 256, 256),
             (1, 50, 50, 4, 256, 256), (1, 25, 25, 2, 256, 256),
             (1, 100, 100, 8, 256, 128), (1, 50, 50, 4, 256, 128),
             (1, 25, 25, 2, 256, 128)]


def _emulate_k6_bf16_kernel(x, k, p):
    """The bf16 kernel's decomposition under plan ``p``, in f32 on the CPU:
    x (B, Y, X, Z, Cin), k (3, 3, 3, Cin, Cout).  Per block (M tile, N
    tile, b, split): for each tap of its range and each 64-channel chunk,
    the A box (TY, TX, Zp, 64) of x at (y0+dy-1, x0+dx-1, dz-1, k0), zero
    outside the volume (TMA's fill), times the B box (BN, 64) of the
    weights relaid out to (27, Cout, Cin), zero past Cout; then the
    epilogue's masked store into the split's partials, and the partials
    summed in split order."""
    B, Y, X, Z, Cin = x.shape
    Cout = k.shape[-1]
    w27 = k.reshape(27, Cin, Cout).permute(0, 2, 1)
    w27 = torch.cat([w27, w27.new_zeros(27, p.tiles_n * p.BN - Cout, Cin)], 1)
    # the zero fill of every box the grid can ask for
    xp = x.new_zeros(B, p.tiles_y * p.TY + 2, p.tiles_x * p.TX + 2, p.Zp + 2,
                     Cin)
    xp[:, 1:Y + 1, 1:X + 1, 1:Z + 1] = x
    parts = x.new_zeros(p.S, B, Y, X, Z, Cout)
    taps = 27 // p.S
    for b, s, tyi, txi, tn in np.ndindex(B, p.S, p.tiles_y, p.tiles_x,
                                         p.tiles_n):
        y0, x0, co0 = tyi * p.TY, txi * p.TX, tn * p.BN
        acc = x.new_zeros(p.BM, p.BN)
        for tap in range(s * taps, (s + 1) * taps):
            dy, dx, dz = tap // 9, tap // 3 % 3, tap % 3
            for k0 in range(0, Cin, 64):
                a = xp[b, y0 + dy:y0 + dy + p.TY, x0 + dx:x0 + dx + p.TX,
                       dz:dz + p.Zp, k0:k0 + 64]
                acc += a.reshape(p.BM, 64) @ w27[tap, co0:co0 + p.BN,
                                                 k0:k0 + 64].T
        acc = acc.reshape(p.TY, p.TX, p.Zp, p.BN)
        ny, nx = min(p.TY, Y - y0), min(p.TX, X - x0)
        nc = min(p.BN, Cout - co0)
        if ny > 0 and nx > 0:
            parts[s, b, y0:y0 + ny, x0:x0 + nx, :, co0:co0 + nc] = \
                acc[:ny, :nx, :Z, :nc]
    y = parts[0]
    for s in range(1, p.S):
        y = y + parts[s]
    return y


def _check_plan(p, B, Y, X, Z, Cin, Cout, sms=K6.SMS):
    """What the kernel and its launch need of a plan."""
    assert p.Zp >= Z and p.Zp < 2 * Z and p.Zp & (p.Zp - 1) == 0
    assert p.BM == p.TY * p.TX * p.Zp and p.BM in (64, 128)
    assert p.BN in (64, 128, 256) and p.S in (1, 3, 9)
    assert p.BN < 256 or p.BM == 128
    assert max(p.TY, p.TX, p.Zp) <= 256              # TMA box edges
    assert (p.tiles_y - 1) * p.TY < Y <= p.tiles_y * p.TY
    assert (p.tiles_x - 1) * p.TX < X <= p.tiles_x * p.TX
    assert (p.tiles_n - 1) * p.BN < Cout <= p.tiles_n * p.BN
    smem = 4 * (p.BM + p.BN) * 128 + 1024 + 64       # conv3d.cu smem_bytes
    assert smem == K6.smem_bytes(p.BM, p.BN) and smem <= 232448
    # split K only where the unsplit grid leaves SMs idle
    blocks = B * p.tiles_y * p.tiles_x * p.tiles_n
    assert p.S == 1 or blocks < sms, (p, blocks)


@pytest.mark.parametrize("shape", K6_SHAPES)
def test_k6_bf16_plan_of_the_flagship_convs(shape):
    """The bf16 kernel's tile plan at each of the flagship frame's K6
    shapes: a legal box and grid; split K at the 25x25x2 volumes, whose
    unsplit grids fill fewer than the card's 132 SMs; 128 x 256 tiles at
    100x100x8 256->256, the largest."""
    _, Y, X, Z, Cin, Cout = shape
    p = K6.plan_bf16(1, Y, X, Z, Cin, Cout)
    _check_plan(p, 1, Y, X, Z, Cin, Cout)
    assert p.S > 1 or Z != 2
    if (Y, Cin, Cout) == (100, 256, 256):
        assert (p.BM, p.BN) == (128, 256)


@pytest.mark.parametrize("sms", [K6.SMS, 1])
@pytest.mark.parametrize("shape,cout", [
    ((1, 10, 6, 3, 64), 80),     # Z' = 4, ragged Cout in a 128-wide tile
    ((2, 5, 12, 12, 128), 48),   # Z' = 16, ragged y edge, two K chunks
])
def test_k6_bf16_tiling_matches_pallas_conv3d(shape, cout, sms):
    """The bf16 kernel's decomposition, emulated in f32 from the wrapper's
    own plan -- boxes zero-filled outside the volume, the Z' rows, split-K
    partials (with the card's 132 SMs these small volumes split; with 1 SM
    they do not) and their sum -- against the TPU kernel in interpret
    mode: 1e-4, f32 sums in another order."""
    B, Y, X, Z, Cin = shape
    p = K6.plan_bf16(B, Y, X, Z, Cin, cout, sms)
    _check_plan(p, B, Y, X, Z, Cin, cout, sms)
    assert (p.S > 1) == (sms == K6.SMS)
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 3, Cin, cout) * 0.05).astype(np.float32)
    want = np.asarray(jconv3d.conv3d_3x3x3(jnp.asarray(x), jnp.asarray(k),
                                           interpret=True))
    got = _emulate_k6_bf16_kernel(torch.from_numpy(x), torch.from_numpy(k),
                                  p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- K8
def test_upsample_int_axis_matches_jax():
    """The port's copy of ``_upsample_int_axis``: f32 to 1e-6; bf16 equal
    (power-of-two factors: exact lerp weights, one rounding per op)."""
    x = np.random.RandomState(3).randn(2, 5, 6, 7, 3).astype(np.float32)
    for axis, s in ((1, 2), (2, 3), (3, 4), (1, 8)):
        want = np.asarray(jlayers._upsample_int_axis(jnp.asarray(x), axis,
                                                     s))
        got = upsample_int_axis(_t(x), axis, s).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jlayers._upsample_int_axis(
        jnp.asarray(x, jnp.bfloat16), 2, 4).astype(jnp.float32))
    got = upsample_int_axis(_t(x, BF16), 2, 4).float().numpy()
    np.testing.assert_array_equal(got, want)


def _tail_inputs(rng, Y=16, X=12, Z=8, C=8, K=19, factors=(1, 2, 4)):
    """Coarse levels (B, Y/f, X/f, Z/f, C), blend weights, BN affine and
    class weights, numpy, channels-last."""
    levels = [rng.randn(1, Y // f, X // f, Z // f, C).astype(np.float32)
              for f in factors]
    w = rng.randn(1, Y, X, Z, len(factors)).astype(np.float32)
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    a = (rng.rand(C) + 0.5).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    k2 = rng.randn(C, K).astype(np.float32)
    return levels, w.astype(np.float32), a, b, k2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_plain_matches_occ_tail(dtype):
    """The port's plain tail -- all three upsamples, blend, BN affine,
    relu, class product, argmax -- vs the JAX caller's Z and Y upsamples
    (``_upsample_int_axis``) and the TPU kernel (interpret) on the result.
    f32: logits 1e-5 relative to max(1, |logit|) (the class product's
    sums in another order), labels on >= 99.9% of voxels.  bf16: logits
    within 2^-5 of max(1, |logit|) (a few bf16 roundings), labels on >=
    99%."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, BF16))
    levels, w, a, b, k2 = _tail_inputs(np.random.RandomState(0))
    jl = []
    for lv in levels:
        v = jnp.asarray(lv, jdt)
        for ax, size in ((3, 8), (1, 16)):
            if v.shape[ax] != size:
                v = jlayers._upsample_int_axis(v, ax, size // v.shape[ax])
        jl.append(v)
    want = np.asarray(jtail.occ_tail(jl, jnp.asarray(w, jdt), jnp.asarray(a),
                                     jnp.asarray(b), jnp.asarray(k2),
                                     interpret=True).astype(jnp.float32))
    labels, logits = K8.occ_tail(
        [_ncdhw(lv).to(tdt) for lv in levels],
        _t(w, tdt).permute(0, 4, 1, 2, 3), _t(a), _t(b), _t(k2),
        return_logits=True)
    assert labels.shape == (1, 16, 12, 8) and labels.dtype == torch.int64
    assert logits.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    d = np.abs(logits.float().numpy() - want) / np.maximum(np.abs(want), 1)
    assert d.max() <= tol, d.max()
    agree = (labels.numpy() == want.argmax(-1)).mean()
    assert agree >= (0.999 if dtype == "float32" else 0.99), agree


def _head_feats(rng, C, sizes):
    return [rng.randn(1, s, s, z, C).astype(np.float32) for s, z in sizes]


def _heads(C, sizes, seed, **kw):
    """A JAX ``OccHead`` with numpy-seeded variables, the port's with the
    same weights (``occ_head_rules``), and the features (numpy, JAX
    layout)."""
    feats = _head_feats(np.random.RandomState(seed), C, sizes)
    jh = JaxOccHead(in_channels=(C, C, C), out_channel=19)
    v = _filled(jax.eval_shape(jh.init, jax.random.PRNGKey(0),
                               [jnp.asarray(f) for f in feats]), seed)
    b = weights._Exporter(v["params"], v["batch_stats"])
    weights.occ_head_rules(b, "", ())
    th = OccHead((C, C, C), 19, **kw)
    sd = {k: torch.from_numpy(np.ascontiguousarray(a))
          for k, a in b.sd.items()}
    th.load_state_dict(sd, strict=False)
    return jh, v, th.eval(), feats


def test_k8_occ_head_label_equivalence(monkeypatch):
    """OccHead under ``FBBEV_OCC_TAIL=1`` (interpret hook) vs the port's
    ``OccHead(occ_tail=True)`` with the same weights: each runs its tail
    kernel once, and labels agree on >= 99.9% of voxels (f32; the JAX
    tail upsamples Z and Y before X, the port too).  The port's tail
    labels also agree with its default path's to 99.9%, as JAX's test
    holds its own two paths."""
    jh, v, th, feats = _heads(32, ((40, 8), (20, 4), (10, 2)), 7,
                              occ_tail=True)
    calls = {}
    _count(monkeypatch, jtail, "occ_tail", calls, "jax")
    _count(monkeypatch, K8, "occ_tail", calls, "port")
    monkeypatch.setenv("FBBEV_OCC_TAIL", "1")
    monkeypatch.setenv("FBBEV_FORCE_OCC_TAIL", "interpret")
    # jitted: the interpreted kernel runs in one compiled program
    want = np.asarray(jax.jit(lambda v, f: jh.apply(
        v, f, return_labels=True))(v, [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        got = th([_ncdhw(f) for f in feats]).numpy()
        th.occ_tail = False
        plain = th([_ncdhw(f) for f in feats]).numpy()
    assert calls == {"jax": 1, "port": 1}
    assert got.shape == want.shape == (1, 80, 80, 16)
    assert (got == want).mean() >= 0.999, (got == want).mean()
    assert (got == plain).mean() >= 0.999, (got == plain).mean()


# ---------------------------------------------------------------- K9
@pytest.mark.parametrize("B,Y,X,Z,C", [(1, 16, 16, 16, 128),
                                       (2, 8, 24, 16, 64)])
def test_k9_plain_matches_fuse_multiscale(B, Y, X, Z, C):
    """The port's plain blend (all three upsamples) vs the JAX caller's Y
    upsample and the TPU kernel (interpret): f32, 1e-5
    (``test_pallas_occ_fuse.py``'s tolerance)."""
    rng = np.random.RandomState(0)
    shapes = [(Y, X, Z), (Y // 2, X // 2, Z // 2), (Y // 4, X // 4, Z // 4)]
    levels = [rng.randn(B, *s, C).astype(np.float32) for s in shapes]
    w = rng.rand(B, Y, X, Z, 3).astype(np.float32)
    jl = [jnp.asarray(lv) if lv.shape[1] == Y else
          jlayers._upsample_int_axis(jnp.asarray(lv), 1, Y // lv.shape[1])
          for lv in levels]
    want = np.asarray(jfuse.fuse_multiscale(jl, jnp.asarray(w),
                                            interpret=True))
    got = K9.fuse_multiscale([_ncdhw(lv) for lv in levels],
                             _t(w).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_k9_occ_head_matches_jax(monkeypatch):
    """OccHead at 256 input channels (128-channel levels, K9's gate) under
    ``FBBEV_OCCFUSE=1``, ``FBBEV_FORCE_OCCFUSE=interpret`` and
    ``FBBEV_OCC_COARSE_PRED=0`` vs the port's ``OccHead(coarse_pred=False,
    occ_fuse=True)``: each runs its blend kernel once; logits agree to
    1e-4 of their largest magnitude (f32), labels on >= 99.9%."""
    jh, v, th, feats = _heads(256, ((8, 4), (4, 2), (2, 1)), 9,
                              coarse_pred=False, occ_fuse=True)
    calls = {}
    _count(monkeypatch, jfuse, "fuse_multiscale", calls, "jax")
    _count(monkeypatch, K9, "fuse_multiscale", calls, "port")
    monkeypatch.setenv("FBBEV_OCCFUSE", "1")
    monkeypatch.setenv("FBBEV_FORCE_OCCFUSE", "interpret")
    monkeypatch.setenv("FBBEV_OCC_COARSE_PRED", "0")
    want = np.asarray(jax.jit(jh.apply)(v, [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        got = th([_ncdhw(f) for f in feats], return_labels=False).numpy()
    assert calls == {"jax": 1, "port": 1}
    assert got.shape == want.shape == (1, 16, 16, 8, 19)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


# ---------------------------------------------------------- the slice
def test_kernel_routed_stream_matches_jax(models, monkeypatch):
    """The small serving stream with ``FBOCC(fuse_warp=False,
    pallas_conv3d=True, occ_tail=True)`` vs the JAX pipeline under
    ``FBBEV_FUSE_WARP=0``, ``FBBEV_OCC_TAIL=1`` and the 3D Pallas conv on
    (interpret hooks; the pool kernel interpreted as in
    ``test_torch_slice``).  On the CPU JAX warps the age-ordered history
    with its XLA fallback (its K5 route is TPU-only), the port with K5's
    plain version.  Per frame: labels on >= 99.9% of voxels, the
    age-ordered history to 1e-4 of its largest value, ages exactly; the
    port routes as many convs to K6 (3 at this config: the 3D ResNet's
    last stage) and tails to K8 (1) as the JAX graph traces."""
    from fbbev_tpu.serving import FixedRigPipeline as JaxPipeline
    from fbbev_tpu_torch.serving import FixedRigPipeline

    jm, v, _ = models
    tm = load_jax_variables(FBOCC(**SMALL, device="cpu", fuse_warp=False,
                                  pallas_conv3d=True, occ_tail=True), v)
    for k, val in (("FBBEV_FORCE_POOL", "interpret"),
                   ("FBBEV_FUSE_WARP", "0"), ("FBBEV_OCC_TAIL", "1"),
                   ("FBBEV_FORCE_OCC_TAIL", "interpret"),
                   ("FBBEV_FORCE_PALLAS_CONV3D", "interpret")):
        monkeypatch.setenv(k, val)
    monkeypatch.setattr(jlayers, "_PALLAS_CONV3D", True)
    jcalls, tcalls = {}, {}
    _count(monkeypatch, jconv3d, "conv3d_3x3x3", jcalls, "K6")
    _count(monkeypatch, jtail, "occ_tail", jcalls, "K8")
    _count(monkeypatch, K6, "conv3d_3x3x3", tcalls, "K6")
    _count(monkeypatch, K8, "occ_tail", tcalls, "K8")
    cam = rig()
    assert_off_voxel_faces(cam)
    jp = JaxPipeline(jm, v, jax_cam(cam))
    tp = FixedRigPipeline(tm, torch_cam(cam))
    rng = np.random.RandomState(1)
    for i, start in enumerate([True, False, False, True, False]):
        imgs = rng.randn(1, 2, 64, 128, 3).astype(np.float32)
        rt = flow(0 if start else i)
        want = np.asarray(jp(imgs, start, rt))
        if i == 0:  # the one trace of the jitted JAX step
            traced = dict(jcalls)
            assert traced == {"K6": 3, "K8": 1}, traced
        tcalls.clear()
        got = tp(imgs, start, rt).numpy()
        assert tcalls == traced, (i, tcalls)
        assert got.shape == want.shape == (1, 40, 40, 16)
        assert (got == want).mean() >= 0.999, (i, (got == want).mean())
        hj = np.asarray(jp.state.history_bev)
        ht = tp.state.history_bev.numpy()
        assert np.abs(hj - ht).max() <= 1e-4 * np.abs(hj).max(), i
        np.testing.assert_array_equal(np.asarray(jp.state.sweep_time),
                                      tp.state.sweep_time.numpy())
    assert jcalls == traced  # no retrace
