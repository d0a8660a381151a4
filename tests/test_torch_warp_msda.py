"""K5 (age-ordered history warp) and K3 / K4 (deformable sampling), as far
as the CPU reaches their card kernels: the plans the wrappers compute
(``pallas_warp.plan_warp``, ``pallas_sample.plan_msda``) and K5's tile
logic emulated in torch -- per task the source box from the flow at the
tile's corner voxels with the kernel's f32 expressions and guard cell,
the staged-or-direct choice, every corner of a staged tile read from the
box, branch-free clamped corners with weight 0 outside the volume, the
tent weights rounded to the volume's type and corners 0..7 summed in f32
-- against K1's plain warp stage run as one slot bit for bit and against
the TPU kernel in interpret mode.

The kernels themselves (``csrc/fuse_warp.cu::warp_box_kernel``,
``csrc/msda.cu::msda_kernel``) run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py --k1``, ``--msda``).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.ops import pallas_warp as jwarp
from fbbev_tpu_torch import geometry
from fbbev_tpu_torch.ops import pallas_fuse_warp as K1
from fbbev_tpu_torch.ops import pallas_sample as K3
from fbbev_tpu_torch.ops import pallas_warp as K5

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(K5.__file__), os.pardir, "csrc")
BF16 = torch.bfloat16


def _src(path):
    with open(os.path.join(CSRC, path)) as f:
        return f.read()


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("plan", K5.WARP_PLANS)
@pytest.mark.parametrize("dtype,C", [(BF16, 1280), (torch.float32, 256),
                                     (BF16, 128), (BF16, 80)])
def test_warp_plan_is_legal(plan, dtype, C):
    """Every instantiated plan at every width the routes give K5 fits the
    card's shared memory at the deepest box; the box is the tile widened
    by the margin each way over the whole (capped) Z; the tasks cover
    every tile and chunk; the grid is persistent."""
    for B, Z, Y, X in ((1, 8, 100, 100), (2, 8, 40, 40), (1, 3, 30, 30)):
        p = K5.plan_warp(B, Z, Y, X, C, dtype, plan=plan)
        ty, tx, m, st, nt, grp = plan
        assert p.smem <= K5.SMEM_LIMIT and nt % 64 == 0
        # a thread's items: its half of NT / 2 voxels apart, all levels
        assert (2 * ty * tx * K5.MAX_BOX_Z) % nt == 0
        assert p.box == (min(Z, K5.MAX_BOX_Z), ty + 2 * m, tx + 2 * m)
        assert p.cc * dtype.itemsize == K5.CELL and C % p.cc == 0
        assert p.stage_bytes == K5.CELL * p.box[0] * p.box[1] * p.box[2]
        assert p.smem == st * p.stage_bytes + 8 * st + 128
        assert p.tasks == B * -(-Y // ty) * -(-X // tx) * -(-(C // p.cc)
                                                          // grp)
        assert p.grid == min(p.tasks, 132)


def test_warp_plan_at_the_flagship():
    """The default plan at the flagship: 4x20 columns (100 = 25 x 4 = 5 x
    20: no ragged tile), a 8x24x8 box of 32-byte rows (16 bf16
    channels), four 49,152-byte stages, 640 threads holding 2 items each;
    125 tiles x 20 groups of 4 chunks over 132 blocks; the box re-reads
    192 / 80 = 2.4 source rows an output column."""
    p = K5.plan_warp(1, 8, 100, 100, 1280, BF16)
    assert (p.TY, p.TX, p.margin, p.stages, p.cc) == (4, 20, 2, 4, 16)
    assert (p.threads, p.group) == (640, 4)
    assert p.box == (8, 8, 24) and p.stage_bytes == 49152
    assert p.smem == 4 * 49152 + 32 + 128 and p.tasks == 125 * 20
    assert p.grid == 132
    assert p.box[1] * p.box[2] / (p.TY * p.TX) == 2.4


@pytest.mark.parametrize("kw", [dict(dtype=torch.float16),
                                dict(C=1288), dict(plan=(16, 16, 1, 2, 256, 8))])
def test_warp_plan_refuses(kw):
    args = dict(B=1, Z=8, Y=100, X=100, C=1280, dtype=BF16)
    args.update(kw)
    with pytest.raises(ValueError, match="takes"):
        K5.plan_warp(**args)


def test_warp_plan_mirrors_the_kernel():
    """The Python plans and constants are the kernel's (``fuse_warp.cu``)."""
    src = _src("fuse_warp.cu")
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kCell"]) == K5.CELL
    assert int(const["kMaxBoxZ"]) == K5.MAX_BOX_Z
    plans = re.findall(r"  FBBEV_K5_PLAN\(" + ", ".join([r"(\d+)"] * 6)
                       + r"\)", src)
    assert tuple(tuple(map(int, p)) for p in plans) == K5.WARP_PLANS


@pytest.mark.parametrize("hd,P", K3.MSDA_SHAPES)
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_msda_plan_is_legal(hd, P, dtype):
    """Every instantiated (hd, P) and type: a staged map fits the card's
    shared memory with its mbarrier, its blocks cover the card without
    exceeding its query tiles; the global path needs none."""
    for B, HW, Q in ((6, 16 * 44, 4096), (1, 10000, 10000),
                     (2, 16 * 44, 100), (12, 16 * 44, 64)):
        p = K3.plan_msda(B, HW, 8, hd, Q, P, dtype)
        assert p.smem <= K3.SMEM_LIMIT and p.threads % 32 == 0
        if p.staged:
            tiles = -(-Q * 8 // p.threads)
            assert p.smem == HW * 8 * hd * dtype.itemsize + 16
            assert 1 <= p.blocks_per_map <= max(1, min(132 // B, tiles))
            assert p.grid == B * p.blocks_per_map
        else:
            assert p.smem == 0
            assert p.grid * p.threads >= B * Q * 8 > (p.grid - 1) * p.threads


def test_msda_staged_at_cross_attention_not_at_self_attention():
    """The cross-attention's 16x44 camera maps (112,640 bytes in bf16) are
    staged, 22 blocks a map on 132 SMs; the self-attention's 100x100 map
    (1.6 MB) is read from global memory."""
    cross = K3.plan_msda(6, 16 * 44, 8, 10, 4096, 8, BF16)
    assert cross.staged and cross.smem == 112640 + 16
    assert cross.blocks_per_map == 22 and cross.grid == 132
    assert K3.plan_msda(6, 16 * 44, 8, 10, 4096, 8, torch.float32).staged
    selfattn = K3.plan_msda(1, 100 * 100, 8, 10, 10000, 4, BF16)
    assert not selfattn.staged and selfattn.smem == 0


def test_msda_plan_refuses_and_mirrors_the_kernel():
    with pytest.raises(ValueError, match="takes"):
        K3.plan_msda(6, 704, 8, 12, 4096, 8, BF16)
    with pytest.raises(ValueError, match="takes"):
        K3.plan_msda(6, 704, 8, 10, 4096, 8, torch.float16)
    src = _src("msda.cu")
    cases = re.findall(r"FBBEV_MSDA_CASE\((\d+), (\d+)\)", src)
    assert sorted((int(h), int(p)) for h, p in cases) == sorted(
        K3.MSDA_SHAPES)
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kMsdaThreads"]) >= max(K3.STAGED_THREADS,
                                             K3.GLOBAL_THREADS)


# ------------------------------------------------------ K5's tile logic
def _src_of(m, gx, gy, gz):
    """The kernel's f32 source coordinates (``fuse_warp.cu::src_of``),
    m (12,) f32, the rest f32 tensors."""
    return tuple(m[4 * r] * gx + m[4 * r + 1] * gy + m[4 * r + 3]
                 + m[4 * r + 2] * gz for r in range(3))


def _boxes(m, plan, Z, Y, X):
    """Every tile's box as ``box_of`` computes it: lo (tiles, 3) in x, y, z
    and fits (tiles,), tiles in row-major (y, x) order."""
    ty, tx, mg = plan[:3]
    dims = (X, Y, Z)
    cells = (tx + 2 * mg, ty + 2 * mg, min(Z, K5.MAX_BOX_Z))
    y0 = torch.arange(0, Y, ty)
    x0 = torch.arange(0, X, tx)
    y0, x0 = (g.reshape(-1) for g in torch.meshgrid(y0, x0, indexing="ij"))
    xa, xb = x0.float(), (torch.clamp(x0 + tx, max=X) - 1).float()
    ya, yb = y0.float(), (torch.clamp(y0 + ty, max=Y) - 1).float()
    corners = [_src_of(m, xb if c & 1 else xa, yb if c & 2 else ya,
                       torch.full_like(xa, float(Z - 1) if c & 4 else 0.0))
               for c in range(8)]
    ext = (X - 1, Y - 1, Z - 1)
    fits = torch.full((len(x0),), Z <= K5.MAX_BOX_Z)
    for r in range(3):
        mag = (m[4 * r].abs() * ext[0] + m[4 * r + 1].abs() * ext[1]
               + m[4 * r + 2].abs() * ext[2] + m[4 * r + 3].abs())
        fits &= bool(mag < 65536.0)
    lo = []
    for d in range(3):
        s = torch.stack([c[d] for c in corners])
        mn, mx = s.min(0).values, s.max(0).values
        top = float(dims[d] - 1)
        lo_d = torch.clamp(torch.floor(mn) - 1.0, 0.0, top).long()
        hi_d = torch.clamp(torch.floor(mx) + 2.0, 0.0, top).long()
        fits &= hi_d - lo_d < cells[d]
        lo.append(lo_d)
    return torch.stack(lo, 1), fits, cells


def _emulate(vol, mat, plan=K5.WARP_PLANS[0]):
    """K5's kernel in torch: returns the warp (B, Y, X, Z, C) and the
    per-sample fits of every tile.  Per voxel the corners are clamped,
    weighted 0 outside the volume and, in a staged tile, taken from the
    box -- each asserted to lie in it -- else from the volume."""
    B, Z, Y, X, C = vol.shape
    ty, tx = plan[:2]
    gz, gy, gx = (g.reshape(-1).float() for g in torch.meshgrid(
        torch.arange(Z), torch.arange(Y), torch.arange(X), indexing="ij"))
    tile = (gy.long() // ty) * -(-X // tx) + gx.long() // tx
    out = torch.zeros(B, Z * Y * X, C, dtype=torch.float32)
    all_fits = []
    for b in range(B):
        m = mat[b, :3, :].float().reshape(12)
        lo, fits, cells = _boxes(m, plan, Z, Y, X)
        all_fits.append(fits)
        xs, ys, zs = _src_of(m, gx, gy, gz)
        x0, y0, z0 = torch.floor(xs), torch.floor(ys), torch.floor(zs)
        staged = fits[tile]
        for c in range(8):
            ix, iy, iz = x0 + (c & 1), y0 + ((c >> 1) & 1), z0 + (c >> 2)
            ok = ((ix >= 0) & (ix <= X - 1) & (iy >= 0) & (iy <= Y - 1)
                  & (iz >= 0) & (iz <= Z - 1))
            w = ((1.0 - torch.abs(xs - ix)) * (1.0 - torch.abs(ys - iy))
                 * (1.0 - torch.abs(zs - iz)))
            w = torch.where(ok, w.to(vol.dtype).float(), torch.zeros_like(w))
            cell = [torch.clamp(v, 0, n - 1).long()
                    for v, n in ((ix, X), (iy, Y), (iz, Z))]
            rel = [cl - lo[tile, d] for d, cl in enumerate(cell)]
            inside = torch.ones_like(staged)
            for d in range(3):
                inside &= (rel[d] >= 0) & (rel[d] < cells[d])
            assert inside[staged].all(), "a staged corner outside its box"
            # a staged cell read at box origin + offset is the same cell
            cx, cy, cz = cell
            row = (cz * Y + cy) * X + cx
            out[b] = out[b] + w[:, None] * vol[b].reshape(-1, C)[row].float()
    warped = out.to(vol.dtype).reshape(B, Z, Y, X, C).permute(0, 2, 3, 1, 4)
    return warped, torch.stack(all_fits)


def _one_slot(vol, mat):
    B, Z, Y, X, C = vol.shape
    curr = torch.zeros(B, Y, X, Z, C, dtype=vol.dtype)
    return K1.fuse_warp_plain(vol, curr, mat, torch.zeros(B),
                              torch.full((B,), -1))[0]


def _flagship_flow():
    dx, bx, _ = geometry.gen_dx_bx((-40, 40, 0.8), (-40, 40, 0.8),
                                   (-1, 5.4, 0.8))
    f2b = torch.from_numpy(geometry.feat2bev_matrix(dx, bx))
    th = 0.01
    c2p = torch.eye(4)[None].clone()
    c2p[0, 0, 0] = c2p[0, 1, 1] = float(np.cos(th))
    c2p[0, 0, 1], c2p[0, 1, 0] = -float(np.sin(th)), float(np.sin(th))
    c2p[0, 0, 3], c2p[0, 1, 3] = 0.5, 0.05
    eye = torch.eye(4)[None]
    return geometry.flow_matrix_from_grid_args(eye, eye, c2p, f2b).float()


def _rigid(theta, tx, ty, n=100, tz=0.0):
    """Rotation by ``theta`` rad about the centre of an n x n grid, then a
    shift of (tx, ty, tz) cells."""
    c, s, h = np.cos(theta), np.sin(theta), (n - 1) / 2
    m = np.eye(4, dtype=np.float32)
    m[0, :2], m[1, :2] = (c, -s), (s, c)
    m[0, 3] = h - c * h + s * h + tx
    m[1, 3] = h - s * h - c * h + ty
    m[2, 3] = tz
    return torch.from_numpy(m[None])


# (flow, what the tiles must do): the flagship's flow(1) stages every
# tile; a shift of 10.5 cells and a lift of 0.6 puts the sources of the
# edge tiles partly outside the volume (clamped boxes, still staged); a
# 0.5 rad rotation with a 7-cell shift sends the inner tiles to the
# fallback and stages the edge tiles whose sources leave the volume
FLOWS = {"flagship": (_flagship_flow, "all"),
         "edges": (lambda: _rigid(0.0, 10.5, -10.5, tz=0.6), "all"),
         "rotation": (lambda: _rigid(0.5, 7.0, 0.0), "mixed")}


@pytest.mark.parametrize("flow", sorted(FLOWS))
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_k5_emulation_is_the_one_slot_plain_warp(flow, dtype):
    """At the flagship's 100x100x8 grid (16 channels), every staged corner
    lies in its tile's box and the emulated warp equals K1's plain warp
    stage run as one slot bit for bit; each flow stages or sends to the
    fallback the tiles it is meant to."""
    make, expect = FLOWS[flow]
    mat = make()
    vol = torch.from_numpy(np.random.RandomState(3).randn(
        1, 8, 100, 100, 16).astype(np.float32)).to(dtype)
    got, fits = _emulate(vol, mat)
    ty, tx = K5.WARP_PLANS[0][:2]
    assert fits.numel() == -(-100 // ty) * -(-100 // tx)
    if expect == "all":
        assert fits.all()
    else:
        assert 0 < int(fits.sum()) < fits.numel()
    assert torch.equal(got, _one_slot(vol, mat))


@pytest.mark.parametrize("plan", K5.WARP_PLANS[1:])
def test_k5_emulation_of_every_plan(plan):
    """The other instantiated plans on a ragged 40x44 grid, two samples
    (one under the rotation): equal to the one-slot plain warp."""
    mat = torch.cat([_rigid(0.05, 1.5, -2.0, n=40), _rigid(0.5, 7.0, 0.0,
                                                           n=40)])
    vol = torch.from_numpy(np.random.RandomState(4).randn(
        2, 8, 40, 44, 8).astype(np.float32)).to(BF16)
    got, fits = _emulate(vol, mat, plan)
    assert fits[0].all() and not fits[1].all()
    assert torch.equal(got, _one_slot(vol, mat))


def test_k5_emulation_matches_pallas_warp():
    """f32, the out_zyx=False layout, inside the TPU kernel's locality
    contract: within 1e-4 of the TPU kernel in interpret mode.  The 5
    degree rotation spreads some tiles' sources over more cells than the
    box holds: those take the fallback, the others are staged."""
    vol = np.random.RandomState(0).randn(1, 8, 40, 40, 128).astype(
        np.float32)
    th = np.deg2rad(5.0)
    m = np.eye(4, dtype=np.float32)
    m[0, :2], m[1, :2] = (np.cos(th), -np.sin(th)), (np.sin(th), np.cos(th))
    m[:3, 3] = (3.7, -2.2, 0.3)
    m[2, 0] = 0.01
    want = np.asarray(jwarp.warp_affine_3d(jnp.asarray(vol),
                                           jnp.asarray(m[None]),
                                           out_zyx=False, interpret=True))
    got, fits = _emulate(torch.from_numpy(vol), torch.from_numpy(m[None]))
    assert 0 < int(fits.sum()) < fits.numel()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
