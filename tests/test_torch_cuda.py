"""The port's CUDA kernels against their plain versions on a card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import).  On the card, where JAX is not installed, run it
without the JAX test configuration: ``python -m pytest --noconftest
tests/test_torch_cuda.py``.  ``chip_smoke.py`` runs the same comparisons
at the flagship shapes.  Tolerances as stated per kernel there.
"""

import numpy as np
import pytest
import torch

from fbbev_tpu_torch import geometry
from fbbev_tpu_torch.ops import pallas_conv as K7
from fbbev_tpu_torch.ops import pallas_conv3d as K6
from fbbev_tpu_torch.ops import pallas_deform as K10
from fbbev_tpu_torch.ops import pallas_fuse_warp as K1
from fbbev_tpu_torch.ops import pallas_occ_fuse as K9
from fbbev_tpu_torch.ops import pallas_occ_tail as K8
from fbbev_tpu_torch.ops import pallas_pool as K2
from fbbev_tpu_torch.ops import pallas_sample as K3
from fbbev_tpu_torch.ops import pallas_warp as K5

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_k2_kernel_matches_plain(dev):
    rng = np.random.RandomState(0)
    B, N, D, fH, fW, C, grid = 1, 3, 6, 4, 8, 80, (12, 10, 4)
    P = B * N * D * fH * fW
    ranks = rng.randint(0, 480, size=P)
    ranks = np.where(rng.rand(P) > 0.7, 480, ranks).astype(np.int32)
    plan = K2.plan_pool(ranks, B, N, D, fH, fW, grid).to(dev)
    depth = torch.rand(B, N, D, fH, fW, device=dev)
    feat = torch.randn(B, N, fH, fW, C, device=dev)
    before = K2.launches
    got = K2.lss_voxel_pool_planned(plan, depth, feat)
    assert K2.launches == before + 1
    want = K2.lss_voxel_pool_precomputed(plan.ranks, depth, feat, grid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
def test_k2_writes_every_row(dev, feat_dtype):
    """K2 through its launch entry into a NaN-filled output, B = 2, one
    row of 200 points (more than a tile's points: a tile alone, walked
    first), f32 and bf16 features: every row written, empty rows 0, all
    within 1e-4 of the plain version on the widened features (f32 sums in
    another order)."""
    rng = np.random.RandomState(3)
    B, N, D, fH, fW, C, grid = 2, 3, 8, 4, 8, 80, (12, 10, 4)
    P, per = B * N * D * fH * fW, 480
    ranks = (np.arange(P) // (P // B)) * per + rng.randint(0, per, size=P)
    ranks = np.where(rng.rand(P) > 0.6, B * per, ranks)
    ranks[rng.choice(P // B, 200, replace=False)] = 7
    plan = K2.plan_pool(ranks.astype(np.int32), B, N, D, fH, fW, grid)
    n = np.diff(plan.row_ptr.numpy())
    assert n.max() >= 200 > K2.TILE_POINTS and (n == 0).any()
    plan = plan.to(dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    depth = torch.rand(B, N, D, fH, fW, generator=g).to(dev)
    feat = torch.randn(B, N, fH, fW, C, generator=g).to(dev, feat_dtype)
    out = torch.full((B, 10, 12, 4, C), float("nan"), device=dev)
    assert K2._launch(plan, depth, feat, out) == 0
    torch.cuda.synchronize()
    assert not out.isnan().any()
    want = K2.lss_voxel_pool_precomputed(plan.ranks, depth, feat.float(),
                                         grid)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    before = K2.launches
    got = K2.lss_voxel_pool_planned(plan, depth, feat)
    assert K2.launches == before + 1
    assert torch.equal(got, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_kernel_matches_plain(dev, dtype):
    g = torch.Generator(device="cpu").manual_seed(0)
    v = torch.randn(2, 16 * 44, 8, 10, generator=g).to(dev, dtype)
    loc = (torch.rand(2, 100, 8, 8, 2, generator=g) * 1.2 - 0.1).to(dev)
    attn = torch.softmax(torch.randn(2, 100, 8, 8, generator=g), -1).to(dev)
    got = K3.deformable_sample_attend(v, (16, 44), loc, attn)
    want = K3.deformable_sample_attend_plain(v, (16, 44), loc, attn)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# (name, B, (H, W), Q, P, selfattn, staged): the cross-attention's camera
# maps (staged in shared memory), a self-attention map too large to stage
# (rows from global memory), and a ragged staged case
K3_CASES = [("cross", 6, (16, 44), 300, 8, False, True),
            ("selfattn", 1, (40, 40), 1600, 4, True, False),
            ("ragged", 3, (7, 9), 77, 4, False, True)]


@pytest.mark.parametrize("case", [c[0] for c in K3_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_staged_and_global_rows_match_plain(dev, dtype, case):
    """K3 and K4 (the self-attention's call) within 1e-4 of the plain
    version, with the map staged in shared memory and with its rows read
    from global memory; each call counts one launch on its own counter."""
    _, B, hw, Q, P, selfattn, staged = next(c for c in K3_CASES
                                            if c[0] == case)
    g = torch.Generator(device="cpu").manual_seed(2)
    H, W = hw
    v = torch.randn(B, H * W, 8, 10, generator=g).to(dev, dtype)
    loc = (torch.rand(B, Q, 8, P, 2, generator=g) * 1.2 - 0.1).to(dev)
    attn = torch.softmax(torch.randn(B, Q, 8, P, generator=g), -1).to(dev)
    assert K3.plan_msda(B, H * W, 8, 10, Q, P, dtype).staged == staged
    before = (K3.launches, K3.selfattn_launches)
    got = K3.deformable_sample_attend(v, hw, loc, attn, selfattn=selfattn)
    after = (K3.launches, K3.selfattn_launches)
    assert after == ((before[0], before[1] + 1) if selfattn
                     else (before[0] + 1, before[1]))
    want = K3.deformable_sample_attend_plain(v, hw, loc, attn)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# (B, T, start, hsel): one sample; two samples of 16 slots, one of them a
# sequence start, the overwritten slot at 0 and at T - 1 (each with V =
# 8 * 20 * 30, not a multiple of the epilogue kernel's 128-voxel tile)
K1_CASES = {"one": (1, 4, [False], [2]),
            "two_start_first": (2, 16, [True, False], [0, 15]),
            "two_start_last": (2, 16, [False, True], [15, 0])}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(K1_CASES))
@pytest.mark.parametrize("epilogue", [False, True])
def test_k1_kernel_matches_plain(dev, epilogue, case, dtype):
    """The new history bit for bit; the warped slots (no epilogue) bit for
    bit; the fused part within 2e-2 in bf16 (f32 sums in another order can
    move y1 across a bf16 rounding before the T*C-row product), 1e-4 of
    its largest value in f32 (the FP32-core epilogue kernel)."""
    B, T, start, hsel = K1_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(1)
    Z, Y, X, C, F = 8, 20, 30, 80, 160
    hist = torch.randn(B, Z, Y, X, T * C, generator=g).to(dev, dtype)
    curr = torch.randn(B, Y, X, Z, C, generator=g).to(dev, dtype)
    dx, bx, _ = geometry.gen_dx_bx((-8, 8, 0.8), (-12, 12, 0.8),
                                   (-1, 5.4, 0.8))
    f2b = torch.from_numpy(geometry.feat2bev_matrix(dx, bx)).to(dev)
    c2p = torch.eye(4, device=dev)[None].repeat(B, 1, 1)
    c2p[:, 0, 3], c2p[:, 1, 3] = 0.5, -0.3
    eye = torch.eye(4, device=dev)[None].expand(B, 4, 4)
    start = torch.tensor(start, device=dev)
    # start samples take the identity flow (the caller's contract)
    mat = torch.where(start[:, None, None], eye,
                      geometry.flow_matrix_from_grid_args(eye, eye, c2p, f2b))
    hsel = torch.tensor(hsel, device=dev)
    epi = None
    if epilogue:
        epi = dict(kc=torch.randn(C, C, generator=g).to(dev) / 9,
                   ke=torch.randn(C, generator=g).to(dev) * 0.1,
                   kb=torch.randn(C, generator=g).to(dev) * 0.1,
                   tvec=torch.rand(B, T, generator=g).to(dev),
                   ws=torch.randn(B, T * C, F, generator=g).to(dev)
                   / (T * C) ** 0.5)
    before = (K1.launches, K1.f32_launches)
    got, gh = K1.fuse_warp(hist, curr, mat, start, hsel, epilogue=epi)
    f32_epi = epilogue and dtype == torch.float32
    assert (K1.launches, K1.f32_launches) == (
        before[0] + (not f32_epi), before[1] + f32_epi)
    want, wh = K1.fuse_warp_plain(hist, curr, mat, start, hsel, epilogue=epi)
    assert torch.equal(gh, wh)
    if f32_epi:
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item()
    elif epilogue:
        assert (got - want).abs().max().item() < 2e-2
    else:
        assert torch.equal(got, want)


def test_k1_refuses_what_its_kernel_does_not_take(dev):
    """No fallback on the card: a (C, F) the epilogue kernel is not built
    for and a misaligned history raise."""
    B, Z, Y, X, C, T = 1, 2, 4, 4, 80, 2
    hist = torch.zeros(B, Z, Y, X, T * C, device=dev, dtype=torch.bfloat16)
    curr = torch.zeros(B, Y, X, Z, C, device=dev, dtype=torch.bfloat16)
    mat = torch.eye(4, device=dev)[None]
    start, hsel = torch.tensor([False], device=dev), torch.tensor([0],
                                                                  device=dev)
    epi = dict(kc=torch.zeros(C, C, device=dev), ke=torch.zeros(C, device=dev),
               kb=torch.zeros(C, device=dev), tvec=torch.zeros(B, T,
                                                               device=dev),
               ws=torch.zeros(B, T * C, 96, device=dev))
    with pytest.raises(ValueError, match="takes \\(C, F\\)"):
        K1.fuse_warp(hist, curr, mat, start, hsel, epilogue=epi)
    flat = torch.zeros(hist.numel() + 1, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        K1.fuse_warp(flat[1:].view(hist.shape), curr, mat, start, hsel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_kernel_matches_plain(dev, dtype):
    """Forward, and input and weight gradients through ``Conv3x3``, on a
    ragged tile (H, W not multiples of a box; Cout 80 not a multiple of
    the N tile, and as the input gradient's Cin a 64-channel box
    zero-filled past 80).  f32: 1e-4; bf16: 2e-2 of max(1, |value|), one
    bf16 rounding of f32 sums taken in another order.  The weight
    gradient against the f32 contractions (``_wgrad_f32``): f32 1e-4; bf16
    (tensor-core products, f32 sums, cast to w's bf16) within one bf16
    rounding, 2^-7 of |value| plus 1e-5 of the largest."""
    g = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn(2, 64, 13, 21, generator=g).to(dev, dtype)
    w = (torch.randn(80, 64, 3, 3, generator=g) / 24).to(dev, dtype)
    gy = torch.randn(2, 80, 13, 21, generator=g).to(dev, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2

    def close(got, want):
        got, want = got.float(), want.float()
        return ((got - want).abs() / want.abs().clamp(min=1.0)).max() <= tol

    f0, d0 = K7.launches, K7.dgrad_launches
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = K7.conv3x3(xg, wg)
    gx, gw = torch.autograd.grad(y, (xg, wg), gy)
    assert (K7.launches, K7.dgrad_launches) == (f0 + 1, d0 + 1)
    assert close(y, K7.conv3x3_s1_plain(x, w))
    assert close(gx, K7.conv3x3_s1_plain(gy, w.flip(2, 3).transpose(0, 1)))
    ref = K7._wgrad_f32(x, gy)
    if dtype == torch.float32:
        assert close(gw, ref)
    else:
        assert gw.dtype == torch.bfloat16
        d = (gw.float() - ref).abs()
        assert (d <= 2.0 ** -7 * ref.abs() + 1e-5 * ref.abs().max()).all()


# K7's shapes in the flagship train step (N, H, W, Cin, Cout), as
# ``chip_smoke.py::K7_SHAPES``, and the ragged Cout-80 case
K7_PLAN_SHAPES = [(6, 64, 176, 64, 64), (6, 32, 88, 128, 128),
                  (6, 16, 44, 256, 256), (6, 8, 22, 512, 512),
                  (6, 16, 44, 256, 512), (6, 16, 44, 512, 512),
                  (8, 100, 100, 64, 64), (4, 50, 50, 128, 128),
                  (2, 25, 25, 256, 256), (8, 100, 100, 256, 256),
                  (4, 50, 50, 256, 256), (8, 100, 100, 256, 128),
                  (4, 50, 50, 256, 128), (2, 25, 25, 256, 128),
                  (2, 13, 21, 64, 80)]


@pytest.mark.parametrize("shape", K7_PLAN_SHAPES)
def test_k7_every_bf16_plan_matches_plain(dev, shape):
    """Every tile plan ``plans_bf16`` offers (BM 64 / 128, each BN, every
    box -- exact fits of fewer pixels than BM among them -- and split),
    launched directly on NaN-filled outputs, forward (Cin
    -> Cout) and input gradient (Cout -> Cin, on w relaid out with its
    channels swapped and taps flipped), vs the plain version: 2e-2 of
    max(1, |y|), as ``test_k7_kernel_matches_plain``."""
    g = torch.Generator(device="cpu").manual_seed(9)
    N, H, W, Cin, Cout = shape
    w = (torch.randn(Cout, Cin, 3, 3, generator=g) * 0.5
         / (9 * Cin) ** 0.5).to(dev, torch.bfloat16)
    for dgrad, ci, co in ((False, Cin, Cout), (True, Cout, Cin)):
        xh = torch.randn(N, H, W, ci, generator=g).to(dev, torch.bfloat16)
        conv_w = w.flip(2, 3).transpose(0, 1) if dgrad else w
        want = K7.conv3x3_s1_plain(xh.permute(0, 3, 1, 2), conv_w).permute(
            0, 2, 3, 1).float()
        plans = [p for _, p in K7.plans_bf16(N, H, W, ci, co)]
        for p in plans:
            y = torch.full((N, H, W, co), float("nan"), device=dev,
                           dtype=torch.bfloat16)
            assert K7._launch_bf16(xh, w, y, p, dgrad) == 0
            d = (y.float() - want).abs() / want.abs().clamp(min=1.0)
            assert d.max().item() <= 2e-2, (dgrad, p)


def test_k7_bf16_takes_strided_weights(dev):
    """A z-slab's weights are a strided view ``w5[..., dz]`` of the 3x3x3
    kernel; the relayout reads them from their strides: forward and input
    gradient vs the plain version, 2e-2 of max(1, |y|)."""
    g = torch.Generator(device="cpu").manual_seed(10)
    w5 = (torch.randn(80, 64, 3, 3, 3, generator=g) / 24).to(
        dev, torch.bfloat16)
    x = torch.randn(3, 64, 9, 17, generator=g).to(dev, torch.bfloat16)
    gy = torch.randn(3, 80, 9, 17, generator=g).to(dev, torch.bfloat16)
    for dz in range(3):
        w = w5[..., dz]
        assert not w.is_contiguous()
        for got, want in (
                (K7.conv3x3_s1(x, w), K7.conv3x3_s1_plain(x, w)),
                (K7._dgrad(gy, w), K7.conv3x3_s1_plain(
                    gy, w.flip(2, 3).transpose(0, 1)))):
            d = (got.float() - want.float()).abs()
            assert (d / want.float().abs().clamp(min=1.0)).max() <= 2e-2


def test_k7_bf16_refuses_a_misaligned_input(dev):
    """TMA reads 16-byte aligned tensors: a bf16 channels-last view 2 bytes
    into its storage raises instead of launching (and the f32 kernel's
    wrapper takes an aligned copy of the same data)."""
    base = torch.zeros(1 * 8 * 16 * 64 + 1, device=dev, dtype=torch.bfloat16)
    x = base[1:].view(1, 8, 16, 64).permute(0, 3, 1, 2)
    w = torch.zeros(64, 64, 3, 3, device=dev, dtype=torch.bfloat16)
    before = K7.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        K7.conv3x3_s1(x, w)
    assert K7.launches == before
    assert K7.conv3x3_s1(x.clone(), w).abs().max().item() == 0.0


def test_k7_zslab_matches_conv3d(dev):
    """``Conv3dZSlabK7`` on the card (three K7 forward and three dgrad
    launches) vs ``F.conv3d``, f32: output and input, weight and bias
    gradients to 1e-4 of max(1, |value|)."""
    import torch.nn.functional as F
    from fbbev_tpu_torch.models.layers import conv
    torch.manual_seed(3)
    m = conv(3, 64, 32, 3, 1, 1, bias=True, pallas3x3=True).to(dev)
    x = torch.randn(2, 64, 10, 13, 3, device=dev, requires_grad=True)
    gy = torch.randn(2, 32, 10, 13, 3, device=dev)
    f0, d0 = K7.launches, K7.dgrad_launches
    y = m(x)
    got = (y,) + torch.autograd.grad(y, (x, m.weight, m.bias), gy)
    assert (K7.launches, K7.dgrad_launches) == (f0 + 3, d0 + 3)
    want = F.conv3d(x, m.weight, m.bias, padding=1)
    ref = (want,) + torch.autograd.grad(want, (x, m.weight, m.bias), gy)
    for a, b in zip(got, ref):
        assert ((a - b).abs() / b.abs().clamp(min=1.0)).max() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_kernel_matches_plain(dev, dtype):
    """K5 (K1's warp stage alone) vs ``grid_sample_3d`` on the flow's grid,
    a rotation with out-of-volume corners.  f32: 1e-4 absolute (the two
    compute the source coordinates in index units and through the [-1, 1]
    grid).  bf16: the kernel rounds each tent weight to bf16 as the TPU
    kernel does, the plain version keeps it f32, both round the sum once:
    within 2^-7 of the volume's largest magnitude."""
    g = torch.Generator(device="cpu").manual_seed(5)
    vol = torch.randn(1, 8, 40, 40, 256, generator=g).to(dev, dtype)
    th = 0.1
    mat = torch.eye(4)[None].clone()
    mat[0, 0, 0] = mat[0, 1, 1] = np.cos(th)
    mat[0, 0, 1], mat[0, 1, 0] = -np.sin(th), np.sin(th)
    mat[0, :3, 3] = torch.tensor([3.7, -2.2, 0.3])
    mat[0, 2, 0] = 0.01
    mat = mat.to(dev)
    before = K5.launches
    got = K5.warp_affine_3d(vol, mat)
    assert K5.launches == before + 1
    want = K5.warp_affine_3d_plain(vol, mat)
    assert got.shape == want.shape == (1, 40, 40, 8, 256)
    tol = 1e-4 if dtype == torch.float32 else \
        2.0 ** -7 * vol.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


def _rigid(theta, tx, ty, n):
    """Rotation by ``theta`` rad about the centre of an n x n grid, then a
    shift of (tx, ty) cells, as a (1, 4, 4) index-unit flow."""
    c, s, h = np.cos(theta), np.sin(theta), (n - 1) / 2
    m = np.eye(4, dtype=np.float32)
    m[0, :2], m[1, :2] = (c, -s), (s, c)
    m[0, 3] = h - c * h + s * h + tx
    m[1, 3] = h - s * h - c * h + ty
    m[2, 0] = 0.01
    return torch.from_numpy(m[None])


@pytest.mark.parametrize("plan", K5.WARP_PLANS)
@pytest.mark.parametrize("dtype,C", [(torch.float32, 256),
                                     (torch.bfloat16, 1280)])
def test_k5_kernel_is_the_one_slot_plain_warp(dev, dtype, C, plan):
    """K5 bit for bit K1's plain warp stage run as one slot (T = 1, curr
    zeros, no start, no slot overwritten), every plan, two samples: a small
    motion (every tile staged) and a 0.5 rad rotation with a 7-cell shift
    (inner tiles take the fallback, edge tiles are staged); one launch."""
    g = torch.Generator(device="cpu").manual_seed(8)
    B, Z, Y, X = 2, 8, 40, 44
    vol = torch.randn(B, Z, Y, X, C, generator=g).to(dev, dtype)
    mat = torch.cat([_rigid(0.02, 1.5, -2.0, 40),
                     _rigid(0.5, 7.0, 0.0, 40)]).to(dev)
    before = K5.launches
    got = K5.warp_affine_3d(vol, mat, plan=plan)
    assert K5.launches == before + 1
    curr = torch.zeros(B, Y, X, Z, C, dtype=dtype, device=dev)
    want = K1.fuse_warp_plain(vol, curr, mat, torch.zeros(B, device=dev),
                              torch.full((B,), -1, device=dev))[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((2, 64, 10, 13, 3), 80),    # Z' = 4, ragged x / y edge and Cout
    ((1, 128, 20, 20, 8), 64),   # two K chunks per tap
    ((1, 64, 5, 18, 2), 128),    # Z' = Z = 2
    ((1, 64, 4, 16, 12), 64),    # Z' = 16
    ((1, 256, 25, 25, 2), 256),  # split K (bf16), as the flagship's
    ((1, 64, 100, 100, 8), 64),  # the flagship's 3D ResNet stage 0
])
def test_k6_kernel_matches_plain(dev, dtype, shape, cout):
    """K6 vs ``F.conv3d`` in f32.  f32: 1e-4 of max(1, |y|); bf16: 2e-2 of
    max(1, |y|), one bf16 rounding of f32 sums taken in another order."""
    if dtype == torch.bfloat16 and shape[1:] == (256, 25, 25, 2):
        B, C, Y, X, Z = shape
        assert K6.plan_bf16(B, Y, X, Z, C, cout, K6._sms(dev)).S > 1
    g = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn(*shape, generator=g).to(dev, dtype)
    w = (torch.randn(cout, shape[1], 3, 3, 3, generator=g)
         / (27 * shape[1]) ** 0.5).to(dev, dtype)
    before = K6.launches
    got = K6.conv3d_3x3x3(x, w)
    assert K6.launches == before + 1
    want = K6.conv3d_3x3x3_plain(x, w)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    d = (got.float() - want.float()).abs() / want.float().abs().clamp(
        min=1.0)
    assert d.max().item() <= tol


@pytest.mark.parametrize("shape,cout", [
    ((1, 128, 9, 10, 3), 80),    # BN 128 over a ragged Cout
    ((2, 64, 6, 7, 5), 192),     # BN 128 and 256, B = 2
    ((1, 64, 5, 4, 16), 48),     # BN 64, Z' = Z = 16
])
def test_k6_every_bf16_plan_matches_plain(dev, shape, cout):
    """Every tile plan ``plans_bf16`` offers (BM 64 / 128, each BN, every
    box and split), launched directly, vs the plain version: 2e-2 of
    max(1, |y|), as ``test_k6_kernel_matches_plain``."""
    g = torch.Generator(device="cpu").manual_seed(8)
    B, C, Y, X, Z = shape
    xh = torch.randn(B, Y, X, Z, C, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(cout, C, 3, 3, 3, generator=g)
         / (27 * C) ** 0.5).to(dev, torch.bfloat16)
    wk = w.permute(2, 3, 4, 0, 1).reshape(27, cout, C).contiguous()
    want = K6.conv3d_3x3x3_plain(xh.permute(0, 4, 1, 2, 3), w).permute(
        0, 2, 3, 4, 1).float()
    plans = [p for _, p in K6.plans_bf16(B, Y, X, Z, C, cout)]
    assert {(p.BM, p.S) for p in plans} == {(bm, s) for bm in (64, 128)
                                            for s in (1, 3, 9)}
    for p in plans:
        y = torch.full((B, Y, X, Z, cout), float("nan"), device=dev,
                       dtype=torch.bfloat16)
        assert K6._launch_bf16(xh, wk, y, p) == 0
        d = (y.float() - want).abs() / want.abs().clamp(min=1.0)
        assert d.max().item() <= 2e-2, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k10_kernel_matches_plain(dev, dtype):
    """K10's corner entry vs its plain version on the same corners, and the
    drop-in equal to the entry: 1e-4 (as K3; f32 sums in another order)."""
    g = torch.Generator(device="cpu").manual_seed(7)
    v = torch.randn(2, 16 * 44, 8, 10, generator=g).to(dev, dtype)
    loc = (torch.rand(2, 101, 8, 8, 2, generator=g) * 1.2 - 0.1).to(dev)
    attn = torch.softmax(torch.randn(2, 101, 8, 8, generator=g), -1).to(dev)
    idx, wgt = K10.corners(loc, attn, 16, 44)
    before = K10.launches
    got = K10.deformable_sample_attend_corners(v, idx, wgt, 8, 8)
    assert K10.launches == before + 1
    want = K10.deformable_sample_attend_corners_plain(v, idx, wgt, 8, 8)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    drop_in = K10.pallas_deformable_sample_attend(v, (16, 44), loc, attn)
    assert torch.equal(drop_in, got)


# (name, B, (H, W), Q, hd, P): the cross-attention's camera maps (staged,
# the ring beside a bf16 map), a ragged staged case at the small config's
# hd, and a map too large to stage (rows from global memory)
K10_CASES = [("cross", 2, (16, 44), 300, 10, 8),
             ("ragged", 3, (7, 9), 77, 8, 4),
             ("global", 1, (40, 40), 1600, 10, 4)]


@pytest.mark.parametrize("case", [c[0] for c in K10_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k10_staged_ring_and_global_rows_match_plain(dev, dtype, case):
    """K10 within 1e-4 of its plain version at staged, ragged and unstaged
    shapes, its counter up by one a call; its plan, the rows loaded
    directly, and a ring of the fewest warps the plan takes it with (a
    block of another size) through the launch entry, each equal to the
    wrapper's result (the same sums in the same order), into NaN-filled
    outputs."""
    _, B, (H, W), Q, hd, P = next(c for c in K10_CASES if c[0] == case)
    g = torch.Generator(device="cpu").manual_seed(9)
    v = torch.randn(B, H * W, 8, hd, generator=g).to(dev, dtype)
    loc = (torch.rand(B, Q, 8, P, 2, generator=g) * 1.2 - 0.1).to(dev)
    attn = torch.softmax(torch.randn(B, Q, 8, P, generator=g), -1).to(dev)
    idx, wgt = K10.corners(loc, attn, H, W)
    before = K10.launches
    got = K10.deformable_sample_attend_corners(v, idx, wgt, 8, P)
    assert K10.launches == before + 1
    want = K10.deformable_sample_attend_corners_plain(v, idx, wgt, 8, P)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    base = K10.plan_corners(B, H * W, 8, hd, Q, P, dtype, ring=False)
    auto = K10.plan_corners(B, H * W, 8, hd, Q, P, dtype)
    plans = {base, auto}
    assert auto.ring == (case == "cross" and dtype == torch.bfloat16)
    if auto.ring:
        w = K10.RING_MIN_WARPS
        per_warp = K10.RING_STAGES * K10.ring_stage_bytes(P)
        plans.add(auto._replace(threads=32 * w,
                                smem=base.smem + w * per_warp))
    for p in plans:
        out = torch.full_like(got, float("nan"))
        assert K10._launch(v, idx, wgt, 8, P, out, p) == 0, p
        torch.cuda.synchronize()
        assert torch.equal(out, got), p


def _occ_levels(g, dev, dtype, C, Y=16, X=24, Z=16, factors=(1, 2, 4, 8),
                B=1):
    """Levels (B, C, Y/fy, X/fx, Z/fz) -- a factor an int for all three
    axes or a (fy, fx, fz) tuple -- and softmax blend weights."""
    fs = [f if isinstance(f, tuple) else (f, f, f) for f in factors]
    levels = [torch.randn(B, C, Y // fy, X // fx, Z // fz, generator=g).to(
        dev, dtype) for fy, fx, fz in fs]
    w = torch.softmax(torch.randn(B, len(fs), Y, X, Z, generator=g),
                      1).to(dev, dtype)
    return levels, w


# (B, Y, X, factors, C): the flagship's factors; two samples; 1-3 levels; a
# tile-ragged Y x X; levels of factor 1 on one axis only (and on two)
OCC_CASES = {"flagship": (1, 16, 24, (1, 2, 4, 8)),
             "two_samples": (2, 16, 24, (1, 2, 4, 8)),
             "one_level": (1, 16, 24, (1,)),
             "two_levels": (1, 16, 24, (1, 4)),
             "three_levels": (1, 16, 24, (1, 2, 8)),
             "ragged": (2, 20, 28, (1, 2, 4)),
             "mixed_factors": (1, 20, 28, (1, (2, 1, 4), (1, 4, 2),
                                           (4, 2, 1))),
             "coarse_only": (1, 16, 24, ((2, 2, 2), (8, 8, 8)))}


@pytest.mark.parametrize("case", sorted(OCC_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_kernel_matches_plain(dev, dtype, case):
    """K8 vs its plain version.  The lerps, the blend and the affine round
    at the same points in both, so they agree exactly; the class product
    sums exact products in f32 in another order: logits within one
    rounding of the type (2^-7 of max(1, |logit|) in bf16, 1e-5 in f32),
    labels on >= 99.5% of voxels (near-ties).  The labels-only launch
    gives the logits launch's labels.  K = 19 as the model; K = 8 and 32
    at the flagship's factors."""
    B, Y, X, factors = OCC_CASES[case]
    for K in ((19, 8, 32) if case == "flagship" else (19,)):
        g = torch.Generator(device="cpu").manual_seed(7)
        levels, w = _occ_levels(g, dev, dtype, 32, Y, X, 16, factors, B)
        a = (torch.rand(32, generator=g) + 0.5).to(dev)
        b = torch.randn(32, generator=g).to(dev)
        k2 = torch.randn(32, K, generator=g).to(dev)
        before = K8.launches
        lab, lg = K8.occ_tail(levels, w, a, b, k2, return_logits=True)
        assert K8.launches == before + 1
        wlab, wlg = K8.occ_tail_plain(levels, w, a, b, k2,
                                      return_logits=True)
        assert lab.dtype == torch.int64 and lab.shape == (B, Y, X, 16)
        assert lg.shape == (B, Y, X, 16, K)
        tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        d = (lg.float() - wlg.float()).abs() / \
            wlg.float().abs().clamp(min=1.0)
        assert d.max().item() <= tol, (K, d.max().item())
        assert (lab == wlab).float().mean().item() >= 0.995, K
        assert torch.equal(K8.occ_tail(levels, w, a, b, k2), lab)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_padded_classes_never_win(dev, dtype):
    """Every logit negative (relu(h) >= 0 against negative class weights):
    the zero logits of the classes the kernel pads K = 19 to 24 with
    would beat every real one if they took part in the argmax."""
    g = torch.Generator(device="cpu").manual_seed(9)
    levels, w = _occ_levels(g, dev, dtype, 32)
    a = (torch.rand(32, generator=g) + 0.5).to(dev)
    b = (torch.rand(32, generator=g) + 0.5).to(dev)     # h > 0
    k2 = -(torch.rand(32, 19, generator=g) + 0.1).to(dev)
    lab, lg = K8.occ_tail(levels, w, a, b, k2, return_logits=True)
    wlab = K8.occ_tail_plain(levels, w, a, b, k2)
    assert lg.float().max().item() < 0
    assert lab.max().item() < 19
    assert (lab == wlab).float().mean().item() >= 0.995


@pytest.mark.parametrize("case", sorted(OCC_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_kernel_matches_plain(dev, dtype, case):
    """K9 vs its plain version: the same rounded ops in the same order,
    so equal."""
    B, Y, X, factors = OCC_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(8)
    levels, w = _occ_levels(g, dev, dtype, 128, Y, X, 16, factors, B)
    before = K9.launches
    got = K9.fuse_multiscale(levels, w)
    assert K9.launches == before + 1
    want = K9.fuse_multiscale_plain(levels, w)
    assert got.shape == (B, 128, Y, X, 16) and got.dtype == dtype
    assert torch.equal(got, want)


def test_occ_wrappers_refuse_what_the_kernel_does_not_take(dev):
    """More than 4 levels, K > 32, a factor that does not divide, mixed
    types, and shared memory past the card's: ValueError, no launch."""
    g = torch.Generator(device="cpu").manual_seed(3)
    levels, w = _occ_levels(g, dev, torch.bfloat16, 16)
    a, b = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    k2 = torch.randn(16, 19, device=dev)
    before = (K8.launches, K9.launches)
    five = levels + levels[-1:]
    w5 = torch.softmax(torch.randn(1, 5, 16, 24, 16, device=dev), 1).to(
        torch.bfloat16)
    bad = [
        lambda: K9.fuse_multiscale(five, w5),
        lambda: K8.occ_tail(five, w5, a, b, k2),
        lambda: K8.occ_tail(levels, w, a, b, torch.randn(16, 33,
                                                         device=dev)),
        lambda: K9.fuse_multiscale(
            [levels[0], torch.randn(1, 16, 5, 12, 8, device=dev).to(
                torch.bfloat16)], w[:, :2].contiguous()),
        lambda: K9.fuse_multiscale([levels[0], levels[1].float()],
                                   w[:, :2].contiguous()),
        lambda: K9.fuse_multiscale(levels, w.float()),
        # Z = 2048 at 16 x 16: one tile row of 256 threads' 8 z values
        # per column and four coarse levels' buffers pass 227 KB
        lambda: K9.fuse_multiscale(*_occ_levels(g, dev, torch.float32, 4,
                                                16, 16, 2048)),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert (K8.launches, K9.launches) == before


def test_small_train_steps_on_card(dev):
    """Two train steps of the small config in bf16 with K7 and stage
    checkpointing: finite metrics, K7 launched in forward and backward,
    none of K1-K3."""
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.models.fbocc import init_temporal_state
    from fbbev_tpu_torch.train import Trainer
    small = dict(
        grid_config={"x": (-40.0, 40.0, 4.0), "y": (-40.0, 40.0, 4.0),
                     "z": (-1.0, 5.4, 0.8), "depth": (2.0, 42.0, 0.5)},
        bevformer_grid_config={"x": (-40.0, 40.0, 4.0),
                               "y": (-40.0, 40.0, 4.0),
                               "z": (-1.0, 5.4, 1.6)},
        input_size=(64, 128), num_cams=2, history_cat_num=2,
        single_bev_num_channels=64, history_cat_conv_out_channels=128,
        depth_mid_channels=64, voxel_channels=(16, 32, 64),
        voxel_out_channels=32, max_queries_per_cam=256)
    model = FBOCC(**small, dtype=torch.bfloat16, device=dev,
                  pallas3x3=True, remat=True,
                  generator=torch.Generator().manual_seed(3))
    trainer = Trainer(model)
    g = torch.Generator().manual_seed(4)
    rng = np.random.RandomState(5)
    # two cameras facing +x and -x at 1.5 m (test_torch_slice's rig)
    rots = [np.stack([[np.sin(th), -np.cos(th), 0.0], [0.0, 0.0, -1.0],
                      [np.cos(th), np.sin(th), 0.0]], 1)
            for th in (0.0, np.pi)]
    cam = dict(rots=np.stack(rots),
               trans=np.array([[0.0137, 0.0137, 1.5137],
                               [0.1137, 0.0637, 1.5137]]),
               intrins=np.tile([[100.0, 0, 64], [0, 100.0, 32], [0, 0, 1]],
                               (2, 1, 1)),
               post_rots=np.tile(np.eye(3), (2, 1, 1)),
               post_trans=np.zeros((2, 3)))
    batch = {k: torch.tensor(np.asarray(v, np.float32))[None].to(dev)
             for k, v in cam.items()}
    occ = torch.from_numpy(rng.randint(0, 19, (1, 40, 40, 16)))
    depth = torch.from_numpy(rng.rand(1, 2, 64, 128).astype(np.float32) * 40)
    batch.update(
        bda=torch.eye(3, device=dev)[None],
        imgs=torch.randn(1, 2, 64, 128, 3, generator=g).to(dev),
        start_of_sequence=torch.tensor([True], device=dev),
        sequence_group_idx=torch.zeros(1, dtype=torch.int32, device=dev),
        curr_to_prev_ego_rt=torch.eye(4, device=dev)[None],
        gt_occupancy=occ.to(dev), gt_depth=depth.to(dev))
    tstate = init_temporal_state(1, (20, 20, 8), 2, 64,
                                 dtype=torch.bfloat16, device=dev)
    before = [m.launches for m in (K1, K2, K3)] + [K3.selfattn_launches]
    f0, d0 = K7.launches, K7.dgrad_launches
    state = trainer.init_state()
    for step in range(2):
        state, tstate, met = trainer.train_step(state, tstate, batch,
                                                do_history=step > 0)
        assert all(np.isfinite(float(v)) for v in met.values()), met
    torch.cuda.synchronize()
    assert K7.launches > f0 and K7.dgrad_launches > d0
    assert [m.launches for m in (K1, K2, K3)] + [
        K3.selfattn_launches] == before


def test_loop_train_resume_evaluate_on_card(dev):
    """``train.loop`` on the card: the tiny config (float32, cut to a
    ResNet-10, batch 1) with K7 for 3 iterations (the curriculum flips at
    2), resumed from its checkpoint to 4, then evaluated from the latest
    checkpoint on 3 samples.  Finite losses; every train step the same
    K7 launches (forward and dgrad, > 0) and none of the serving
    kernels; the restored state equal to the saved one; the evaluation
    K1 (its f32 kernel) once and K3 twice (cross- and self-attention) a
    sample, K2 and K7 never.  Its checkpoints live in a temporary
    directory."""
    import os
    import tempfile
    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.train import checkpoints as CK
    from fbbev_tpu_torch.train import loop
    cfg = Config.fromfile(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "fbbev_tpu_torch", "configs", "fbocc-r50-tiny_synthetic.py"))
    cfg.merge_from_options({
        "model.backbone_depth": "10", "model.depth_mid_channels": "64",
        "model.img_feat_channels": "64", "data.batch_size": "1",
        "log_interval": "1", "checkpoint_interval": "100",
        "temporal_start_iter": "2"})
    serving = (K1, K2, K3, K5, K6, K8, K9, K10)

    def count():
        return ([K7.launches, K7.dgrad_launches]
                + [m.launches for m in serving]
                + [K1.f32_launches, K3.selfattn_launches])

    per_step = []
    real = loop.Trainer.train_step

    def step(self, *a, **k):
        before = count()
        out = real(self, *a, **k)
        per_step.append([x - y for x, y in zip(count(), before)])
        return out

    loop.Trainer.train_step = step
    try:
        with tempfile.TemporaryDirectory() as d:
            first = loop.train(cfg, max_iters=3, work_dir=d, device=dev,
                               pallas3x3=True)
            ckpts = os.path.join(d, "ckpts")
            restored = CK.restore_checkpoint(ckpts, first["state"])
            for k in ("params", "batch_stats", "ema_params",
                      "ema_batch_stats"):
                assert torch.equal(getattr(restored, k),
                                   getattr(first["state"], k)), k
            second = loop.train(cfg, max_iters=4, work_dir=d, device=dev,
                                resume=True, pallas3x3=True)
            assert int(second["state"].step) == 4
            for h in first["history"] + second["history"]:
                assert all(np.isfinite(v) for v in h.values()), h
            assert len(per_step) == 4
            assert per_step[0][0] > 0 and per_step[0][1] > 0
            assert all(c == per_step[0][:2] + [0] * (len(c) - 2)
                       for c in per_step), per_step
            before = count()
            res = loop.evaluate(cfg, work_dir=d, max_samples=3, device=dev)
            torch.cuda.synchronize()
            delta = dict(zip(
                ["k7", "k7_dgrad", "k1", "k2", "k3", "k5", "k6", "k8", "k9",
                 "k10", "k1_f32", "k4"],
                [x - y for x, y in zip(count(), before)]))
    finally:
        loop.Trainer.train_step = real
    assert res["n_samples"] == 3 and np.isfinite(res["Overall"])
    assert delta == dict(k7=0, k7_dgrad=0, k1=0, k2=0, k3=3, k5=0, k6=0,
                         k8=0, k9=0, k10=0, k1_f32=3, k4=3), delta
