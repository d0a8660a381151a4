"""K2's row plan and K10's per-(query, head) walk, emulated in numpy
against the JAX package's TPU kernels (Pallas interpreter on the CPU).

* K2 (``ops/pallas_pool.py``): the plan's legality (every valid point
  once, monotone row pointers over every output row, tiles of consecutive
  rows within their limits, heaviest first), its counts at the flagship
  rig, and a numpy emulation of ``csrc/bev_pool.cu``'s walk -- a tile's
  points in order with separately rounded f32 products and sums, each row
  written when its last point is summed, empty rows with zeros --
  against ``pallas_pool.lss_voxel_pool_planned`` in interpret mode with
  f32 and bf16 features (1e-5: f32 sums in another order).
* K10 (``ops/pallas_deform.py``): a numpy emulation of ``csrc/msda.cu``'s
  walk from precomputed corners -- one (map, query, head) at a time, its
  points then corners in order, each corner weight rounded to the value
  type -- against ``pallas_deform.pallas_deformable_sample_attend`` in
  interpret mode, f32 and bf16 value maps (1e-5), and the corner plan's
  legality.
"""

import os
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fbbev_tpu.ops import pallas_deform as jdeform
from fbbev_tpu.ops import pallas_pool as jpool
from fbbev_tpu_torch.ops import pallas_deform as K10
from fbbev_tpu_torch.ops import pallas_pool as K2

torch.set_num_threads(1)


# ---------------------------------------------------------------- K2
def random_ranks(rng, B, N, D, fH, fW, grid_size, valid_frac=0.6,
                 crowd=0):
    """Ranks in natural point order, ``1 - valid_frac`` of the points out
    of the grid; ``crowd`` more points of batch 0 sent to one voxel (a
    row longer than a tile's points)."""
    nx, ny, nz = grid_size
    P = B * N * D * fH * fW
    per = nx * ny * nz
    ranks = (np.arange(P) // (P // B)) * per + rng.randint(0, per, size=P)
    ranks = np.where(rng.rand(P) > valid_frac, B * per, ranks)
    ranks[rng.choice(P // B, crowd, replace=False)] = per // 2
    return ranks.astype(np.int32)


CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "fbbev_tpu_torch", "csrc", "bev_pool.cu")


def kernel_warps():
    """The warps of a block of ``csrc/bev_pool.cu``, read from its source:
    the ranges a long row's points are cut into."""
    with open(CU) as f:
        src = f.read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    assert re.search(r"constexpr int kWarps = kThreads / 32;", src)
    return threads // 32


WARPS = kernel_warps()


def tiles_of(plan):
    """(first row, rows) of each tile of the plan's work, in its order."""
    w = plan.work.numpy().astype(np.int64)
    return w >> 5, w & 31


def emulate_k2(plan, depth, feat):
    """``csrc/bev_pool.cu``'s walk in numpy f32 -> (B, Y, X, Z, C): a
    tile's points in order, separately rounded products and sums, a row
    written when its last point is summed, the tile's empty rows with
    zeros; a long row as WARPS consecutive ranges of its points, their
    sums added in order.  Rows no tile writes stay NaN."""
    nx, ny, nz = plan.grid_size
    C = feat.shape[-1]
    fd = depth.reshape(-1).astype(np.float32)
    ff = feat.reshape(-1, C).astype(np.float32)
    rp, pts = plan.row_ptr.numpy(), plan.pts.numpy()
    out = np.full((rp.size - 1, C), np.nan, np.float32)

    def summed(ks):
        acc = np.zeros(C, np.float32)
        for p in pts[ks]:
            acc = acc + fd[p] * ff[p // (plan.D * plan.NR) * plan.NR
                                   + p % plan.NR]
        return acc

    for t, (r0, nrows) in enumerate(zip(*tiles_of(plan))):
        if t < plan.n_long:
            s, n = rp[r0], rp[r0 + 1] - rp[r0]
            per = -(-n // WARPS)
            parts = [summed(slice(s + min(n, w * per), s + min(n, (w + 1)
                                                                * per)))
                     for w in range(WARPS)]
            acc = parts[0]
            for q in parts[1:]:
                acc = acc + q
            out[r0] = acc
            continue
        for r in range(r0, r0 + nrows):
            out[r] = summed(slice(rp[r], rp[r + 1]))
    return out.reshape(plan.batch, ny, nx, nz, C)


def check_plan(plan, ranks, B, rows=K2.TILE_ROWS, points=K2.TILE_POINTS):
    """Legality of a K2 plan against the ranks it was built from."""
    nx, ny, nz = plan.grid_size
    per = nx * ny * nz
    rp, pts = plan.row_ptr.numpy(), plan.pts.numpy()
    valid = np.flatnonzero(ranks < B * per)
    # every valid point exactly once, each in its own output row
    np.testing.assert_array_equal(np.sort(pts), valid)
    assert rp.size == B * per + 1 and rp[0] == 0 and rp[-1] == pts.size
    assert (np.diff(rp) >= 0).all()
    r = ranks[pts].astype(np.int64)
    b, rem = r // per, r % per
    z, y, x = rem // (nx * ny), (rem // nx) % ny, rem % nx
    row_of = np.repeat(np.arange(B * per), np.diff(rp))
    np.testing.assert_array_equal(((b * ny + y) * nx + x) * nz + z, row_of)
    # points of a row keep their natural order
    assert (np.diff(pts)[row_of[1:] == row_of[:-1]] > 0).all()
    # tiles cover every row once, within their limits, heaviest first,
    # the long rows (more points than a tile takes) first and alone
    r0, nrows = tiles_of(plan)
    assert (nrows >= 1).all() and (nrows <= rows).all()
    covered = np.zeros(B * per, np.int64)
    np.add.at(covered, np.concatenate([np.arange(a, a + n)
                                       for a, n in zip(r0, nrows)]), 1)
    assert (covered == 1).all()
    npts = rp[r0 + nrows] - rp[r0]
    assert (np.diff(npts) <= 0).all()
    assert ((npts > points) == (np.arange(r0.size) < plan.n_long)).all()
    assert (nrows[:plan.n_long] == 1).all()


@pytest.mark.parametrize("rows,points", [(4, 8), (16, 64), (31, 128)])
def test_k2_plan_is_legal(rows, points):
    rng = np.random.RandomState(1)
    B, N, D, fH, fW, grid = 2, 3, 5, 4, 8, (12, 10, 4)
    ranks = random_ranks(rng, B, N, D, fH, fW, grid, crowd=37)
    plan = K2.plan_pool(ranks, B, N, D, fH, fW, grid, rows=rows,
                        points=points)
    check_plan(plan, ranks, B, rows, points)
    n = np.diff(plan.row_ptr.numpy())
    assert n.max() >= 37 and (n == 0).any()
    assert plan.n_long == int((n > points).sum())


def test_k2_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        K2.plan_pool(np.zeros(40, np.int32), 1, 1, 5, 2, 4, (2, 2, 2),
                     rows=32)
    K2.check_channels(80)
    K2.check_channels(128)
    for C in (6, 0, 132):
        with pytest.raises(ValueError):
            K2.check_channels(C)


def test_k2_plan_at_the_flagship_rig():
    """The flagship's rig (``chip_smoke.flagship_rig``): 212,672 valid
    points of 337,920 in 54,375 of the 80,000 rows, the longest 169 points,
    160 rows longer than a tile's 64 points, each walked by a block; the
    default plan is legal."""
    import chip_smoke
    ranks, fp, _, _ = chip_smoke.flagship_pool_inputs("cpu")
    plan = K2.plan_pool(ranks, 1, 6, fp.D, 16, 44, fp.grid_size)
    n = np.diff(plan.row_ptr.numpy())
    assert ranks.size == 337920 and plan.pts.numel() == 212672
    assert n.size == 80000 and int((n > 0).sum()) == 54375
    assert int(n.max()) == 169 and int(np.median(n[n > 0])) == 2
    assert plan.n_long == 160
    check_plan(plan, ranks, 1)
    r0, nrows = tiles_of(plan)
    assert nrows[0] == 1 and n[r0[0]] == 169


@pytest.mark.parametrize("feat_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,N,rows,points", [(1, 2, 4, 8), (2, 3, 16, 16),
                                             (2, 3, 31, 128)])
def test_k2_emulation_matches_pallas_pool(B, N, rows, points, feat_dtype):
    """The kernel's walk (a row longer than a tile's points, empty rows,
    bf16 features) vs the interpreted TPU kernel, and the wrapper's plain
    version: 1e-5."""
    rng = np.random.RandomState(B * 10 + N)
    D, fH, fW, C = 5, 4, 8, 24
    grid = (12, 10, 4)
    ranks = random_ranks(rng, B, N, D, fH, fW, grid, crowd=29)
    depth = rng.rand(B, N, D, fH, fW).astype(np.float32)
    feat = rng.randn(B, N, fH, fW, C).astype(np.float32)
    jfeat = jnp.asarray(feat)
    if feat_dtype == "bf16":
        feat = feat.astype(ml_dtypes.bfloat16)
        jfeat = jnp.asarray(feat)
    want = np.asarray(jpool.lss_voxel_pool_planned(
        jpool.plan_pool(ranks, B, N, D, fH, fW, grid, K=64, R=64),
        jnp.asarray(depth), jfeat, interpret=True))
    plan = K2.plan_pool(ranks, B, N, D, fH, fW, grid, rows=rows,
                        points=points)
    got = emulate_k2(plan, depth, feat)
    assert not np.isnan(got).any()                # every row written
    assert (got == 0).all(-1).sum() > 0            # empty rows among them
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tfeat = torch.from_numpy(feat.astype(np.float32))
    if feat_dtype == "bf16":
        tfeat = tfeat.to(torch.bfloat16)
    plain = K2.lss_voxel_pool_planned(plan, torch.from_numpy(depth), tfeat)
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- K10
def emulate_k10(value, idx, wgt, heads, P):
    """``msda.cu``'s walk from corners in numpy: per (map, query, head) the
    hd sums in f32, over points then corners in order, each product of a
    corner weight rounded to the value type and a value widened to f32;
    separately rounded products and sums (``--fmad=false``)."""
    B, HW, _, hd = value.shape
    Q = idx.shape[1] // (heads * P)
    v = value.astype(np.float32)
    ii = idx.reshape(B, Q, heads, P, 4)
    ww = wgt.reshape(B, Q, heads, P, 4).astype(value.dtype).astype(
        np.float32)
    b = np.arange(B)[:, None, None]
    h = np.arange(heads)[None, None, :]
    acc = np.zeros((B, Q, heads, hd), np.float32)
    for p in range(P):
        for k in range(4):
            acc = acc + ww[..., p, k, None] * v[b, ii[..., p, k], h]
    return acc.reshape(B, Q, heads * hd)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd,P", [(10, 8), (8, 4)])
def test_k10_emulation_matches_pallas_deform(dtype, hd, P):
    """The kernel's per-(query, head) walk on :func:`pallas_deform.corners`
    vs the interpreted TPU kernel (locations from -0.1 to 1.1, a Q not a
    multiple of its tile) and the corner entry's plain version: both round
    each corner weight to the value type and sum exact products in f32, so
    they agree to f32 rounding (1e-5)."""
    rng = np.random.RandomState(hd + P)
    B, H, W, heads, Q = 2, 6, 9, 4, 37
    v = rng.randn(B, H * W, heads, hd).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Q, heads, P, 2)).astype(np.float32)
    a = rng.randn(B, Q, heads, P).astype(np.float32)
    a = (np.exp(a) / np.exp(a).sum(-1, keepdims=True)).astype(np.float32)
    if dtype == "bf16":
        v = v.astype(ml_dtypes.bfloat16)
    want = np.asarray(jdeform.pallas_deformable_sample_attend(
        jnp.asarray(v), (H, W), jnp.asarray(loc), jnp.asarray(a),
        interpret=True))
    idx, wgt = K10.corners(torch.from_numpy(loc), torch.from_numpy(a), H, W)
    got = emulate_k10(v, idx.numpy(), wgt.numpy(), heads, P)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tv = torch.from_numpy(v.astype(np.float32))
    plain = K10.deformable_sample_attend_corners(
        tv.to(torch.bfloat16) if dtype == "bf16" else tv, idx, wgt, heads, P)
    np.testing.assert_allclose(plain.numpy(), got, rtol=1e-5, atol=1e-5)


def test_k10_plan_at_the_cross_attention_shapes():
    """K10 at K3's cross-attention shapes: the bf16 map (112,640 bytes) is
    staged and leaves room for 6 warps' two-stage rings (192 threads a
    block, 22 blocks a map); the f32 map (225,280) leaves none, so the rows
    are loaded directly by 512 threads, as at 4 points a pair and beside a
    map that leaves room for fewer than 3 warps' rings; a 20x50 map leaves
    room for 3; the self-attention's map is not staged; a (hd, P) the
    kernel does not take raises."""
    f = K10.plan_corners
    p = f(6, 704, 8, 10, 4096, 8, torch.bfloat16)
    assert (p.staged, p.ring, p.threads, p.blocks_per_map, p.grid) == \
        (True, True, 192, 22, 132)
    assert p.smem == 112640 + 16 + 6 * 2 * K10.ring_stage_bytes(8) <= \
        K10.SMEM_LIMIT
    assert K10.ring_stage_bytes(8) == 2 * 32 * 144
    p = f(6, 704, 8, 10, 4096, 8, torch.float32)
    assert (p.staged, p.ring, p.threads, p.smem) == (True, False, 512,
                                                     225296)
    p = f(6, 704, 8, 10, 4096, 8, torch.bfloat16, ring=False)
    assert (p.ring, p.threads, p.smem) == (False, 512, 112656)
    for HW, hd, P in ((704, 10, 4), (704, 8, 4), (1200, 10, 8)):
        p = f(6, HW, 8, hd, 4096, P, torch.bfloat16)
        assert (p.staged, p.ring, p.threads) == (True, False, 512)
    p = f(6, 1000, 8, 10, 4096, 8, torch.bfloat16)
    assert (p.ring, p.threads, p.smem) == (
        True, 96, 160000 + 16 + 3 * 2 * K10.ring_stage_bytes(8))
    p = f(1, 10000, 8, 10, 10000, 4, torch.bfloat16)
    assert (p.staged, p.ring, p.smem) == (False, False, 0)
    with pytest.raises(ValueError):
        f(6, 704, 8, 12, 4096, 8, torch.bfloat16)


@pytest.mark.parametrize("P", [8, 4])
def test_k10_ring_layout(P):
    """``msda.cu::ring_fill``'s copy and the lanes' reads of a stage in
    numpy: chunk c of a warp tile (lane c % 32, instruction c // 32) lands
    where lane c // P reads its point c % P; each instruction copies 512
    contiguous bytes; the lanes of a quarter warp reading the same point of
    their pairs hit 8 different 16-byte bank groups; pairs past the tile's
    end read zeros."""
    RR = 16 * P + 16
    n = 23                                   # pairs of the tile that exist
    rows = np.arange(1000, 1000 + 32 * P * 4).reshape(-1, 4)  # idx rows
    row0 = 5
    stage = np.full((2 * 32 * RR) // 4, -1, np.int64)
    for i in range(P):                        # the warp's instructions
        srcs = []
        for lane in range(32):
            c = lane + 32 * i
            pr = c // P
            ok = pr < n
            src = row0 * P + c if ok else 0
            d = pr * RR + (c % P) * 16
            stage[d // 4:d // 4 + 4] = rows[src] if ok else 0
            srcs.append(src)
        if 32 * (i + 1) <= n * P:
            assert np.array_equal(np.diff(srcs), np.ones(31))
    for lane in range(32):
        for p in range(P):
            got = stage[(lane * RR + 16 * p) // 4:][:4]
            want = rows[(row0 + lane) * P + p] if lane < n else np.zeros(4)
            np.testing.assert_array_equal(got, want)
    for q in range(4):
        for p in range(P):
            groups = {((8 * q + j) * RR + 16 * p) // 16 % 8 for j in range(8)}
            assert len(groups) == 8
