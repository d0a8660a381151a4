"""K1's epilogue card kernel, as far as the CPU reaches it: the plan the
wrapper computes (``pallas_fuse_warp.plan_epilogue``), and the kernel's
decomposition emulated in torch -- per 128-voxel tile the branch-free
corner table (clamped rows, zero weights outside the volume), the gather
and ring update, the K-major weights zero-filled past C as the TMA boxes
bring them, the per-slot bf16 roundings, the f32 accumulator summed in
slot order and the (z, y, x) -> (y, x, z) store -- against the TPU kernel
in interpret mode, and its gather against the port's plain version bit
for bit.

The kernel itself (``csrc/fuse_warp.cu::fuse_warp_epi``) runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py --k1``).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.ops import pallas_fuse_warp as jfw
from fbbev_tpu_torch import geometry as tgeo
from fbbev_tpu_torch.ops import pallas_fuse_warp as K1

from tests.test_torch_slice import flow

torch.set_num_threads(1)

CU = os.path.join(os.path.dirname(K1.__file__), os.pardir, "csrc",
                  "fuse_warp.cu")


# ---------------------------------------------------------------- plan
@pytest.mark.parametrize("B,Z,Y,X,C,F", [
    (1, 8, 100, 100, 80, 160),   # the flagship: 625 tiles exactly
    (1, 8, 20, 30, 80, 160),     # the card tests: ragged
    (2, 8, 20, 30, 80, 160),
    (1, 8, 20, 20, 64, 128),     # chip_smoke's small config: 25 tiles
    (2, 3, 5, 7, 64, 128),       # ragged, one tile
])
def test_k1_epilogue_plan_is_legal(B, Z, Y, X, C, F):
    """Within the card's shared memory, the grid covers every voxel with no
    tile wholly outside, and the rows of the last tile past V (masked by
    the kernel) are fewer than a tile."""
    p = K1.plan_epilogue(B, Z, Y, X, C, F)
    V = Z * Y * X
    assert p.BM == 128 and p.smem <= K1.SMEM_LIMIT
    assert p.k_steps == -(-C // 64) and p.grid[1] == B
    assert (p.grid[0] - 1) * p.BM < V <= p.grid[0] * p.BM
    masked = p.grid[0] * p.BM - V
    assert 0 <= masked < p.BM
    assert (masked == 0) == (V % 128 == 0)
    if (Y, X) == (100, 100):
        assert p.grid == (625, 1)


def test_k1_epilogue_plan_at_the_flagship():
    """The flagship's plan: two K steps of 64 channels (C = 80), and the
    byte count of the reference design (~205 KB), buffer by buffer."""
    p = K1.plan_epilogue(1, 8, 100, 100, 80, 160)
    row = 2 * 128
    buffers = [2 * 128 * row,      # A ring
               2 * 64 * row,       # A2, one per consumer warpgroup
               2 * 160 * row,      # ws ring
               80 * row,           # kc^T
               128 * 8 * 8,        # corner rows and weights
               8 * 13, 1024]       # mbarriers, alignment slack
    assert p.k_steps == 2 and p.smem == sum(buffers) == 210024


def test_k1_epilogue_plan_mirrors_the_kernel():
    """The Python plan's constants are the kernel's (``fuse_warp.cu``)."""
    with open(CU) as f:
        src = f.read()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kEpiRows"]) == K1.BM
    assert int(const["kAStages"]) == K1.A_STAGES
    assert int(const["kWStages"]) == K1.W_STAGES
    shapes = re.findall(r"C == (\d+) && F == (\d+)\) return launch_epi", src)
    assert sorted((int(c), int(f)) for c, f in shapes) == sorted(
        K1.EPI_SHAPES)


@pytest.mark.parametrize("C,F", [(80, 96), (96, 160), (80, 128)])
def test_k1_epilogue_plan_refuses_other_widths(C, F):
    with pytest.raises(ValueError, match="takes"):
        K1.plan_epilogue(1, 8, 20, 30, C, F)


# ---------------------------------------------------------- emulation
def _table(mat, Z, Y, X, dt):
    """The kernel's corner table: for tile row v (every tile, v clamped to
    V - 1 past the volume) its 8 corner rows, each coordinate clamped into
    the volume, and tent weights rounded to ``dt``, 0 for a corner outside
    the volume.  Returns rows (B, n, 8) int64, weights (B, n, 8) f32 and
    the clamped voxel of each row (n,)."""
    B, V = mat.shape[0], Z * Y * X
    n = -(-V // K1.BM) * K1.BM
    vc = torch.arange(n).clamp(max=V - 1)
    gx = (vc % X).float()[None]
    gy = ((vc // X) % Y).float()[None]
    gz = (vc // (X * Y)).float()[None]
    m = mat[:, :3, :].float().reshape(B, 12, 1)
    xs = m[:, 0] * gx + m[:, 1] * gy + m[:, 3] + m[:, 2] * gz
    ys = m[:, 4] * gx + m[:, 5] * gy + m[:, 7] + m[:, 6] * gz
    zs = m[:, 8] * gx + m[:, 9] * gy + m[:, 11] + m[:, 10] * gz
    x0, y0, z0 = torch.floor(xs), torch.floor(ys), torch.floor(zs)
    rows, wts = [], []
    for k in range(8):
        ix, iy, iz = x0 + (k & 1), y0 + ((k >> 1) & 1), z0 + (k >> 2)
        ok = ((ix >= 0) & (ix <= X - 1) & (iy >= 0) & (iy <= Y - 1)
              & (iz >= 0) & (iz <= Z - 1))
        w = ((1.0 - torch.abs(xs - ix)) * (1.0 - torch.abs(ys - iy))
             * (1.0 - torch.abs(zs - iz)))
        cx, cy, cz = (c.clamp(0, hi - 1).long()
                      for c, hi in ((ix, X), (iy, Y), (iz, Z)))
        rows.append((cz * Y + cy) * X + cx)
        wts.append(torch.where(ok, w.to(dt).float(), torch.zeros_like(w)))
    return torch.stack(rows, -1), torch.stack(wts, -1), vc


def _gather(hist, curr, mat, start, hsel):
    """The gather warps: per slot and tile row the A-stage row (the warped
    slot after the start reset, in the history's type) and the new
    history's row, corners summed in order k = 0..7 in f32.  Returns A
    (B, n, T, C) over every tile row and the new history (B, Z, Y, X, T*C)
    of the rows below V."""
    B, Z, Y, X, TC = hist.shape
    C = curr.shape[-1]
    T, V, dt = TC // C, Z * Y * X, hist.dtype
    rows, w, vc = _table(mat, Z, Y, X, dt)
    h = hist.reshape(B, V, TC).float()
    cur = curr.permute(0, 3, 1, 2, 4).reshape(B, V, C).float()[:, vc]
    s = start.float().reshape(B, 1, 1)
    a_rows, new = [], []
    for t in range(T):
        ht = h[:, :, t * C:(t + 1) * C]
        acc = torch.zeros(B, vc.numel(), C)
        for k in range(8):
            g = torch.gather(ht, 1, rows[..., k, None].expand(-1, -1, C))
            acc = acc + w[..., k, None] * g
        w0 = acc * (1.0 - s) + cur * s
        mk = (hsel.reshape(B, 1, 1) == t).float()
        a_rows.append(w0.to(dt))
        new.append((w0 * (1.0 - mk) + cur * mk).to(dt))
    new_hist = torch.stack(new, 2)[:, :V].reshape(B, Z, Y, X, TC)
    return torch.stack(a_rows, 2), new_hist


def _boxes(t, C):
    """TMA's boxes of 64 channels over a K-major tensor (..., C): the K
    steps side by side, zero past C."""
    ks = -(-C // 64)
    out = torch.zeros(*t.shape[:-1], 64 * ks, dtype=t.dtype)
    out[..., :C] = t
    return out


def _emulate(hist, curr, mat, start, hsel, epi):
    """``fuse_warp_epi``'s decomposition: the gather into A stages, then per
    slot and 64-row consumer half Y1 = A @ kc^T over the k16 slices that
    hold channels, relu(Y1 + brow) rounded to the history type (A2), ACC
    += A2 @ ws[t]^T, f32, slots in order; ACC stored (z, y, x) -> (y, x,
    z) for the rows below V."""
    B, Z, Y, X, TC = hist.shape
    C = curr.shape[-1]
    T, V, dt = TC // C, Z * Y * X, hist.dtype
    A, new_hist = _gather(hist, curr, mat, start, hsel)
    kc_t, ws_t = K1.relayout_epilogue(epi, B, T, C, dtype=dt)
    kbox, wbox = _boxes(kc_t, C).float(), _boxes(ws_t, C).float()
    # the slices past C / 16 that the kernel skips are TMA's zero fill
    assert not kbox[:, C:].any() and not wbox[..., C:].any()
    F = ws_t.shape[1]
    brow = K1._brow(epi)
    a = _boxes(A, C).float()                            # (B, n, T, 64 ks)
    acc = torch.zeros(B, a.shape[1], F)
    for t in range(T):
        y1 = torch.zeros(B, a.shape[1], C)
        for kk in range(C // 16):
            sl = slice(16 * kk, 16 * kk + 16)
            y1 = y1 + a[:, :, t, sl] @ kbox[:, sl].T
        a2 = _boxes(torch.relu(y1 + brow[:, t, None]).to(dt), C).float()
        wt = wbox.reshape(B, T, F, -1)[:, t]            # (B, F, 64 ks)
        for kk in range(C // 16):
            sl = slice(16 * kk, 16 * kk + 16)
            acc = acc + a2[..., sl] @ wt[..., sl].transpose(1, 2)
    fused = torch.empty(B, Y, X, Z, F)
    v = torch.arange(V)
    fused[:, (v // X) % Y, v % X, v // (X * Y)] = acc[:, :V]
    return fused, new_hist


def _case(rng, B, Z, Y, X, C, T, F, starts, hsels, step, cell=4.0):
    """numpy inputs: history, curr, the flow of stream step ``step`` (the
    identity for start samples), start flags, slots to overwrite and the
    epilogue's weights."""
    dx, bx, _ = tgeo.gen_dx_bx((-X * cell / 2, X * cell / 2, cell),
                               (-Y * cell / 2, Y * cell / 2, cell),
                               (-1, 5.4, 0.8))
    f2b = torch.from_numpy(tgeo.feat2bev_matrix(dx, bx))
    eye = torch.eye(4)[None].expand(B, 4, 4)
    mat = tgeo.flow_matrix_from_grid_args(
        eye, eye, torch.from_numpy(flow(step)).expand(B, 4, 4), f2b)
    mat = torch.where(torch.tensor(starts)[:, None, None], eye, mat)
    args = dict(hist=rng.randn(B, Z, Y, X, T * C).astype(np.float32),
                curr=rng.randn(B, Y, X, Z, C).astype(np.float32),
                mat=mat.numpy().astype(np.float32),
                start=np.array(starts), hsel=np.array(hsels, np.int32))
    epi = dict(kc=rng.randn(C, C) / np.sqrt(C), ke=rng.randn(C) * 0.1,
               kb=rng.randn(C) * 0.1, tvec=rng.rand(B, T) * 4.0,
               ws=rng.randn(B, T * C, F) / np.sqrt(T * C))
    return args, {k: np.asarray(e, np.float32) for k, e in epi.items()}


ORDER = ("hist", "curr", "mat", "start", "hsel")


def _run_both(args, epi, jdt, tdt):
    """The JAX kernel in interpret mode and the emulation on the same
    inputs, history and curr in the given types."""
    want, want_h = jfw.fuse_warp(
        *[jnp.asarray(args[k]).astype(jdt) if k in ("hist", "curr")
          else jnp.asarray(args[k]) for k in ORDER],
        interpret=True, epilogue={k: jnp.asarray(e) for k, e in epi.items()})
    t = {k: torch.from_numpy(args[k]) for k in ORDER}
    got, got_h = _emulate(t["hist"].to(tdt), t["curr"].to(tdt), t["mat"],
                          t["start"], t["hsel"],
                          {k: torch.from_numpy(e) for k, e in epi.items()})
    return got, got_h, np.asarray(want), np.asarray(
        want_h.astype(jnp.float32))


# (B, Z, Y, X, C, T, F, starts, hsels): the flagship's widths C 80, F 160
# at T 8 and Z 4 (the TPU kernel's channel block is a multiple of 640, and
# its f32 slabs of Z x 16 x 24 x 640 must fit its VMEM budget), and the
# small config's 64 / 128; a start sample, the overwritten slot at 0 and
# at T - 1; V = 2400 (a ragged last tile) and 3200
JAX_CASES = [(2, 4, 20, 30, 80, 8, 160, [True, False], [0, 7]),
             (1, 8, 20, 20, 64, 2, 128, [False], [1])]


@pytest.mark.parametrize("case", JAX_CASES, ids=["c80f160", "c64f128"])
def test_k1_epilogue_emulation_matches_fuse_warp_f32(case):
    """f32 to 1e-4: the new history, and the fused part relative to its
    largest value (the TPU kernel computes the tent weights in
    slab-relative coordinates, here absolute ones, ~30 cells: a float32
    rounding of the weights of ~1e-6; and the products sum in another
    order)."""
    B, Z, Y, X, C, T, F, starts, hsels = case
    args, epi = _case(np.random.RandomState(11), B, Z, Y, X, C, T, F,
                      starts, hsels, step=1)
    got, got_h, want, want_h = _run_both(args, epi, jnp.float32,
                                         torch.float32)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", JAX_CASES, ids=["c80f160", "c64f128"])
def test_k1_epilogue_emulation_matches_fuse_warp_bf16(case):
    """bf16 history.  The emulated new history is the port's plain version
    bit for bit.  Against the TPU kernel, the tolerances of test_k1_plain_
    bf16_history_matches_fuse_warp: the new history differs on under 0.1%
    of the elements, the fused part by 1e-2 of its largest value.  Its
    per-element bound, one bf16 ulp (2^-7) of the value, is made exact
    where the 8 corners cancel: the TPU kernel's slab-relative tent
    weights may round to the neighbouring bf16 value (one ulp, 2^-7 of
    each weight), so a value may move by 2^-7 of sum_k |w_k g_k| plus one
    ulp of itself (the plain version shows the same few elements here)."""
    B, Z, Y, X, C, T, F, starts, hsels = case
    args, epi = _case(np.random.RandomState(12), B, Z, Y, X, C, T, F,
                      starts, hsels, step=1)
    got, got_h, want, want_h = _run_both(args, epi, jnp.bfloat16,
                                         torch.bfloat16)
    t = {k: torch.from_numpy(args[k]) for k in ORDER}
    hist, curr = t["hist"].to(torch.bfloat16), t["curr"].to(torch.bfloat16)
    _, plain_h = K1.fuse_warp_plain(hist, curr, t["mat"], t["start"],
                                    t["hsel"])
    assert torch.equal(got_h, plain_h)
    # sum_k |w_k g_k| (tent weights are >= 0), |curr| in the reset slots
    mag = _gather(hist.abs(), curr.abs(), t["mat"], t["start"],
                  t["hsel"])[1].float().numpy()
    d = np.abs(got_h.float().numpy() - want_h)
    assert (d > 0).mean() < 1e-3
    assert (d <= 2.0 ** -7 * (np.maximum(np.abs(want_h), 1e-3)
                              + mag)).all()
    assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("starts,hsels", [([True, False], [0, 3]),
                                          ([False, True], [3, 0])])
def test_k1_branch_free_gather_is_the_plain_warp(dtype, starts, hsels):
    """The gather of the epilogue kernel -- corners outside the volume read
    at the clamped row with weight 0, rows past V at voxel V - 1 -- gives
    the plain version's warped slots and new history bit for bit, under a
    motion of several cells that puts many corners outside the volume."""
    B, Z, Y, X, C, T = 2, 8, 20, 30, 80, 4
    args, _ = _case(np.random.RandomState(13), B, Z, Y, X, C, T, 160,
                    starts, hsels, step=6, cell=0.8)
    t = {k: torch.from_numpy(args[k]) for k in ORDER}
    hist, curr = t["hist"].to(dtype), t["curr"].to(dtype)
    rows, w, _ = _table(t["mat"], Z, Y, X, dtype)
    assert (w == 0).any(dim=-1)[~torch.tensor(starts)].float().mean() > 0.2
    A, new_hist = _gather(hist, curr, t["mat"], t["start"], t["hsel"])
    slots, want_h = K1.fuse_warp_plain(hist, curr, t["mat"], t["start"],
                                       t["hsel"])
    V = Z * Y * X
    want = slots.permute(0, 3, 1, 2, 4).reshape(B, V, T, C)
    assert torch.equal(A[:, :V], want)
    assert torch.equal(new_hist, want_h)
    # the rows of the ragged last tile repeat voxel V - 1
    assert torch.equal(A[:, V:], A[:, V - 1:V].expand_as(A[:, V:]))
