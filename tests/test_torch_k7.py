"""K7's bf16 card kernel, as far as the CPU reaches it: the tile plan the
wrapper computes (``pallas_conv.plan_bf16``), the kernel's decomposition
emulated in f32 against the TPU kernel in interpret mode, forward and
input gradient, and the weight gradient's bf16 product path against the
JAX package's f32 ``einsum``.

The kernel itself (``csrc/conv3x3.cu``) runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); what surrounds it --
plan, the weight relayout's strides and flip (the input gradient's
weights), boxes, zero fill, tap order, split-K partials and their ordered
sum -- is Python or is emulated here from the same plan and weight
arguments the wrapper hands the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.ops import pallas_conv as jconv
from fbbev_tpu_torch.ops import pallas_conv as K7
from fbbev_tpu_torch.ops import pallas_conv3d as K6

torch.set_num_threads(1)

# K7's launches in one forward pass of the flagship: (N, H, W, Cin, Cout)
# and how many, as ``chip_smoke.py::K7_SHAPES``
K7_SHAPES = [((6, 64, 176, 64, 64), 3), ((6, 32, 88, 128, 128), 3),
             ((6, 16, 44, 256, 256), 6), ((6, 8, 22, 512, 512), 2),
             ((6, 16, 44, 256, 512), 1), ((6, 16, 44, 512, 512), 6),
             ((8, 100, 100, 64, 64), 12), ((4, 50, 50, 128, 128), 9),
             ((2, 25, 25, 256, 256), 12), ((8, 100, 100, 256, 256), 3),
             ((4, 50, 50, 256, 256), 3), ((8, 100, 100, 256, 128), 3),
             ((4, 50, 50, 256, 128), 3), ((2, 25, 25, 256, 128), 3)]

# and in the FB-BEV detection head's (``fbbev-r50-det_16f.py`` with
# pallas3x3, B=1, ``chip_smoke.py::K7_HEAD_SHAPES``): the shared conv on
# the Z-folded BEV (8 x 256 channels) and the 36 branch convs
K7_HEAD_SHAPES = [((1, 100, 100, 2048, 64), 1), ((1, 100, 100, 64, 64), 36)]

# and in VoVNet-99 at 6 cameras x 512x1408 (``fbocc-vov99_depth_16f_
# 512x1408.py`` with pallas3x3, ``chip_smoke.py::VOV_K7_SHAPES``): the
# convs with Cin % 64 == 0 -- stem_2, stage 2's, the first conv of each
# block of stages 3-5, stage 4's conv1-4 -- Cout 160 and 224 among them
VOV_K7_SHAPES = [((6, 256, 704, 64, 64), 1), ((6, 128, 352, 128, 128), 5),
                 ((6, 64, 176, 256, 160), 1), ((6, 64, 176, 512, 160), 2),
                 ((6, 32, 88, 512, 192), 1), ((6, 32, 88, 768, 192), 8),
                 ((6, 32, 88, 192, 192), 36), ((6, 16, 44, 768, 224), 1),
                 ((6, 16, 44, 1024, 224), 2)]


def _check_plan(p, N, H, W, Cin, Cout, sms=K6.SMS):
    """What the kernel and its launch need of a plan."""
    assert p.BM in (64, 128) and p.BM // 2 < p.TY * p.TX <= p.BM
    assert p.BN in (64, 128, 256) and (p.BN < 256 or p.BM == 128)
    assert max(p.TY, p.TX) <= 256                    # TMA box edges
    # the grid covers the output, and no tile lies wholly outside it
    assert (p.tiles_y - 1) * p.TY < H <= p.tiles_y * p.TY
    assert (p.tiles_x - 1) * p.TX < W <= p.tiles_x * p.TX
    assert (p.tiles_n - 1) * p.BN < Cout <= p.tiles_n * p.BN
    smem = 4 * (p.BM + p.BN) * 128 + 1024 + 64       # Ring<>::kSmem
    assert smem == K6.smem_bytes(p.BM, p.BN) and smem <= 232448
    steps = K7.k_steps(Cin)
    assert steps == 9 * -(-Cin // 64) and steps % p.S == 0
    # split K only where the unsplit grid leaves SMs idle
    blocks = N * p.tiles_y * p.tiles_x * p.tiles_n
    assert p.S == 1 or blocks < sms, (p, blocks)


@pytest.mark.parametrize("shape", [s for s, _ in K7_SHAPES])
def test_k7_bf16_plan_of_the_train_convs(shape):
    """The bf16 kernel's plan at each K7 shape of the flagship train step,
    forward (Cin -> Cout) and input gradient (Cout -> Cin): a legal box,
    tiling and split, within the card's shared memory."""
    N, H, W, Cin, Cout = shape
    for a, b in ((Cin, Cout), (Cout, Cin)):
        _check_plan(K7.plan_bf16(N, H, W, a, b), N, H, W, a, b)


@pytest.mark.parametrize("shape", [s for s, _ in K7_HEAD_SHAPES],
                         ids=["shared_conv", "branch_conv"])
def test_k7_bf16_plan_of_the_detection_head(shape):
    """The detection head's convs take K7 (the routing gate holds, as
    JAX's ``_pallas3x3_eligible`` with the port's Cout % 16), and the
    bf16 kernel has a legal plan for each, forward and input gradient
    (the shared conv's dgrad 64 -> 2048)."""
    N, H, W, Cin, Cout = shape
    assert K7.supports((N, Cin, H, W), Cout)
    for a, b in ((Cin, Cout), (Cout, Cin)):
        _check_plan(K7.plan_bf16(N, H, W, a, b), N, H, W, a, b)


@pytest.mark.parametrize("shape", [s for s, _ in VOV_K7_SHAPES],
                         ids=["x".join(map(str, s)) for s, _ in VOV_K7_SHAPES])
def test_k7_bf16_plan_of_the_vovnet_convs(shape):
    """VoVNet-99's gated convs take K7 and have a legal bf16 plan forward
    (a partial last N tile at Cout 160 and 224) and in the input gradient
    (Cout as its input channels: a partial last 64-channel K box at 160
    and 224), stem_2's 6 x 256x704 the largest M K7 has taken."""
    N, H, W, Cin, Cout = shape
    assert K7.supports((N, Cin, H, W), Cout)
    for a, b in ((Cin, Cout), (Cout, Cin)):
        _check_plan(K7.plan_bf16(N, H, W, a, b), N, H, W, a, b)


def test_k7_bf16_plans_split_the_small_convs():
    """The convs whose unsplit grids fill few of the 132 SMs split their K
    steps (6x8x22 512->512: 24 blocks of 128 x 256; 2x25x25 256->256: 28);
    the 100x100 z-slabs, hundreds of blocks, do not."""
    assert K7.plan_bf16(6, 8, 22, 512, 512).S > 1
    assert K7.plan_bf16(2, 25, 25, 256, 256).S > 1
    assert K7.plan_bf16(8, 100, 100, 256, 256).S == 1


def _emulate_relayout(w, dgrad, k_major):
    """The entries' relayout kernel (``conv3x3.cu relayout``) on the
    strides and flip the wrapper hands it (``_weight_args``): the conv's
    weights tap-major, (9, O, I) with ``k_major``, else (9, I, O)."""
    so, si, sy, sx, flip = K7._weight_args(w, dgrad)
    O, I = (w.shape[1], w.shape[0]) if dgrad else (w.shape[0], w.shape[1])
    taps = []
    for t in range(9):
        ky, kx = divmod(8 - t if flip else t, 3)
        wc = torch.as_strided(w, (O, I), (so, si),
                              w.storage_offset() + ky * sy + kx * sx)
        taps.append(wc if k_major else wc.t())
    return torch.stack(taps)


def _emulate_k7_bf16_kernel(x, wk, p):
    """The bf16 kernel's decomposition under plan ``p``, in f32 on the CPU:
    x (N, H, W, Cin), wk (9, Cout, Cin) as the relayout writes it.  Per
    block (M tile, N tile, n, split): for each K step of its range in order
    -- taps outer, 64-channel boxes inner -- the A box (TY, TX, 64) of x
    at (y0+dy-1, x0+dx-1, k0), zero outside the image and past Cin (TMA's
    fill), times the B box (BN, 64) of weight tap (dy, dx), zero past Cout
    and Cin; then the epilogue's masked store into the split's partials,
    and the partials summed in split order."""
    N, H, W, Cin = x.shape
    Cout = wk.shape[1]
    kc = -(-Cin // 64)
    steps = 9 * kc // p.S
    wz = x.new_zeros(9, p.tiles_n * p.BN, kc * 64)
    wz[:, :Cout, :Cin] = wk
    # the zero fill of every box the grid can ask for
    xp = x.new_zeros(N, p.tiles_y * p.TY + 2, p.tiles_x * p.TX + 2, kc * 64)
    xp[:, 1:H + 1, 1:W + 1, :Cin] = x
    parts = x.new_zeros(p.S, N, H, W, Cout)
    for n, s, tyi, txi, tn in np.ndindex(N, p.S, p.tiles_y, p.tiles_x,
                                         p.tiles_n):
        y0, x0, co0 = tyi * p.TY, txi * p.TX, tn * p.BN
        acc = x.new_zeros(p.TY * p.TX, p.BN)   # the rows the box fills
        for step in range(s * steps, (s + 1) * steps):
            tap, k0 = step // kc, step % kc * 64
            dy, dx = tap // 3, tap % 3
            a = xp[n, y0 + dy:y0 + dy + p.TY, x0 + dx:x0 + dx + p.TX,
                   k0:k0 + 64]
            b = wz[tap, co0:co0 + p.BN, k0:k0 + 64]
            acc += a.reshape(p.TY * p.TX, 64) @ b.T
        acc = acc.reshape(p.TY, p.TX, p.BN)
        ny, nx = min(p.TY, H - y0), min(p.TX, W - x0)
        nc = min(p.BN, Cout - co0)
        if ny > 0 and nx > 0 and nc > 0:
            parts[s, n, y0:y0 + ny, x0:x0 + nx, co0:co0 + nc] = \
                acc[:ny, :nx, :nc]
    y = parts[0]
    for s in range(1, p.S):
        y = y + parts[s]
    return y


def _plans_to_emulate(N, H, W, Cin, Cout, which):
    """The wrapper's plan on the card (132 SMs) or on one SM, or the
    best-ranked plan of every split S the conv allows."""
    if which != "every_split":
        return [K7.plan_bf16(N, H, W, Cin, Cout, K6.SMS if which == "card"
                             else 1)]
    best = {}
    for key, p in sorted(K7.plans_bf16(N, H, W, Cin, Cout)):
        best.setdefault(p.S, p)
    return list(best.values())


@pytest.mark.parametrize("which", ["card", "one_sm", "every_split"])
@pytest.mark.parametrize("shape", [
    (2, 5, 11, 80, 48),    # ragged edge; Cin 80: a box zero-filled past Cin
    (1, 9, 20, 64, 144),   # a ragged 128-wide N tile
    (1, 6, 10, 2048, 64),  # the detection head's shared conv, cut in space
    (1, 5, 12, 64, 64),    # its branch convs, cut in space
    # VoVNet-99's, cut in space: Cout 160 and 224 leave a partial N tile,
    # and as the input gradient's Cin a partial last K box
    (1, 6, 10, 256, 160),  # stage 3's first conv
    (1, 4, 9, 768, 224),   # stage 5's first conv of a later block
])
def test_k7_bf16_tiling_matches_pallas_conv(shape, which):
    """The bf16 kernel's decomposition, emulated in f32 from the wrapper's
    own plans and weight relayout, against the TPU kernel in interpret
    mode: the forward conv (``conv3x3_s1``) and the input gradient of its
    VJP (``jax.vjp`` of ``conv3x3``: the conv of g with flipped,
    transposed weights, which the relayout reads from w's strides).  f32
    to 1e-5 (sums of 9*Cin products in another order; O(1) outputs)."""
    N, H, W, Cin, Cout = shape
    rng = np.random.RandomState(4)
    x = rng.randn(N, H, W, Cin).astype(np.float32)
    w = (rng.randn(3, 3, Cin, Cout) * 0.05).astype(np.float32)
    g = rng.randn(N, H, W, Cout).astype(np.float32)
    y_j, vjp = jax.vjp(lambda x: jconv.conv3x3(x, jnp.asarray(w)),
                       jnp.asarray(x))
    dx_j = vjp(jnp.asarray(g))[0]
    np.testing.assert_allclose(
        np.asarray(y_j), np.asarray(jconv.conv3x3_s1(
            jnp.asarray(x), jnp.asarray(w), interpret=True)), rtol=0, atol=0)
    w_t = torch.from_numpy(w).permute(3, 2, 0, 1)        # (Cout, Cin, 3, 3)
    for dgrad, inp, want, ci, co in (
            (False, x, y_j, Cin, Cout), (True, g, dx_j, Cout, Cin)):
        wk = _emulate_relayout(w_t, dgrad, k_major=True)
        assert tuple(wk.shape) == (9, co, ci)
        plans = _plans_to_emulate(N, H, W, ci, co, which)
        if which == "every_split":
            assert len(plans) == len([s for s in K7.SPLITS
                                      if K7.k_steps(ci) % s == 0]) > 1
        for p in plans:
            _check_plan(p, N, H, W, ci, co,
                        1 if which == "one_sm" else K6.SMS)
            got = _emulate_k7_bf16_kernel(torch.from_numpy(inp), wk, p)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5, err_msg=str(p))


@pytest.mark.parametrize("k_major", [True, False])
def test_k7_relayout_reads_the_convs_weights(k_major):
    """The strides and flip the wrapper hands the relayout kernel, read as
    the kernel reads them, give the forward's weights ``w`` and the input
    gradient's ``w.flip(2, 3).transpose(0, 1)`` tap for tap, in the bf16
    kernel's (9, out, in) and the f32 kernel's (9, in, out) layout -- also
    for a z-slab's weights, a strided view ``w5[..., dz]`` of a 3x3x3
    kernel."""
    w5 = torch.randn(48, 80, 3, 3, 3)
    for w in (w5[..., 0].contiguous(), w5[..., 1]):
        for dgrad, conv_w in ((False, w),
                              (True, w.flip(2, 3).transpose(0, 1))):
            wk = _emulate_relayout(w, dgrad, k_major)
            for t in range(9):
                tap = conv_w[:, :, t // 3, t % 3]
                torch.testing.assert_close(wk[t], tap if k_major else tap.t(),
                                           rtol=0, atol=0)


@pytest.mark.parametrize("N,H,W,Cin,Cout", [(2, 12, 16, 64, 48),
                                            (1, 7, 9, 128, 80)])
@pytest.mark.parametrize("channels_last", [True, False])
def test_k7_bf16_wgrad_matches_jax_einsum(N, H, W, Cin, Cout,
                                         channels_last):
    """The weight gradient's bf16 path (``_wgrad_bf16``: one product of x's
    nine shifted windows side by side and g's pixels, f32 sums; on the CPU
    in f32 of the same bf16 values) against the JAX VJP's f32 einsum
    of bf16 x and g cast to bf16 (w's type): within one bf16 rounding --
    each is an f32 sum of the same exact products in another order,
    rounded once, so an element may land one bf16 ulp (2^-7 of its
    magnitude) away where the sums straddle a rounding boundary, plus
    f32 noise (1e-5 of the largest) for elements near zero; and against
    the f32 path (``_wgrad_f32``) on the same values to 1e-5 of the
    largest; x and g in channels-last and in NCHW memory."""
    rng = np.random.RandomState(5)
    xb = torch.from_numpy(rng.randn(N, H, W, Cin).astype(np.float32)).to(
        torch.bfloat16)
    gb = torch.from_numpy(rng.randn(N, H, W, Cout).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, Cin, Cout) * 0.05).astype(
        np.float32)).to(torch.bfloat16)
    to_j = (lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    _, vjp = jax.vjp(jconv.conv3x3, to_j(xb), to_j(w))
    dw_j = vjp(to_j(gb))[1]
    assert dw_j.dtype == jnp.bfloat16
    want = np.asarray(dw_j.astype(jnp.float32))          # (3, 3, Cin, Cout)
    x_t, g_t = xb.permute(0, 3, 1, 2), gb.permute(0, 3, 1, 2)
    if not channels_last:                   # NCHW memory: the copies differ
        x_t, g_t = x_t.contiguous(), g_t.contiguous()
    got32 = K7._wgrad_bf16(x_t, g_t)
    assert got32.dtype == torch.float32
    assert tuple(got32.shape) == (Cout, Cin, 3, 3)
    scale = np.abs(want).max()
    ref32 = K7._wgrad_f32(x_t, g_t)
    np.testing.assert_allclose(got32.numpy(), ref32.numpy(), rtol=0,
                               atol=1e-5 * scale)
    got = got32.to(torch.bfloat16).float().permute(2, 3, 1, 0).numpy()
    d = np.abs(got - want)
    assert (d <= 2.0 ** -7 * np.abs(want) + 1e-5 * scale).all()
    assert (d > 0).mean() < 1e-2


def test_k7_bf16_wgrad_sums_its_pixel_slices(monkeypatch):
    """With the weight gradient's product cut into slices of 100 pixels
    (``WGRAD_ROWS``; 2 x 9 x 13 = 234 pixels: two whole slices and a
    partial one) its f32 result equals the f32 path's (``_wgrad_f32``) to
    1e-5 of the largest value, as unsliced."""
    monkeypatch.setattr(K7, "WGRAD_ROWS", 100)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 64, 9, 13).astype(np.float32)).to(
        torch.bfloat16)
    g = torch.from_numpy(rng.randn(2, 32, 9, 13).astype(np.float32)).to(
        torch.bfloat16)
    got, want = K7._wgrad_bf16(x, g), K7._wgrad_f32(x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())
