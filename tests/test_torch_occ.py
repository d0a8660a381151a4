"""K8 (occ tail) and K9 (occ blend), as far as the CPU reaches their card
kernel (``csrc/occ_tail.cu``): the plan the wrappers compute
(``pallas_occ_tail.plan_occ``) and the kernel's decomposition emulated in
torch -- per tile the clamped coarse neighbourhoods, the separable lerps
axis by axis in the JAX order with the tap tables' rounded weights, every
op rounded to the levels' type, the blend in level order, the tail's class
product in k16 chunks and its argmax over the classes < K -- against the
plain versions bit for bit and against the TPU kernel in interpret mode.
Also the claim the kernel's bf16 pair arithmetic rests on: one rounding of
the exact sum or product of two bf16 values is what f32-then-round gives.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py --occ``).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.models import layers as jlayers
from fbbev_tpu.ops import pallas_occ_tail as jtail
from fbbev_tpu_torch.ops import pallas_occ_fuse as K9
from fbbev_tpu_torch.ops import pallas_occ_tail as K8

torch.set_num_threads(1)

CU = os.path.join(os.path.dirname(K8.__file__), os.pardir, "csrc",
                  "occ_tail.cu")
BF16 = torch.bfloat16
FLAGSHIP = [(200 // f, 200 // f, 16 // f) for f in (1, 2, 4, 8)]


def _dims(Y, X, Z, factors):
    fs = [f if isinstance(f, tuple) else (f, f, f) for f in factors]
    return [(Y // fy, X // fx, Z // fz) for fy, fx, fz in fs]


# ---------------------------------------------------------------- plan
PLAN_CASES = [  # (B, C, Y, X, Z, dims, tail, itemsize, K)
    (1, 128, 200, 200, 16, FLAGSHIP, False, 2, 0),
    (1, 128, 200, 200, 16, FLAGSHIP, False, 4, 0),
    (1, 64, 200, 200, 16, FLAGSHIP, True, 2, 19),
    (1, 64, 200, 200, 16, FLAGSHIP, True, 4, 19),
    (1, 128, 16, 24, 16, _dims(16, 24, 16, (1, 2, 4, 8)), False, 2, 0),
    (1, 32, 16, 24, 16, _dims(16, 24, 16, (1, 2, 4, 8)), True, 2, 32),
    (2, 32, 16, 24, 16, _dims(16, 24, 16, (1, 2, 4, 8)), True, 4, 8),
    (2, 128, 20, 28, 16, _dims(20, 28, 16, (1, 2, 4)), False, 2, 0),
    (1, 32, 20, 28, 16, _dims(20, 28, 16, (1, (2, 1, 4), (1, 4, 2),
                                           (4, 2, 1))), True, 2, 19),
    (2, 3, 5, 7, 6, _dims(5, 7, 6, (1, (5, 7, 3))), False, 2, 0),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_occ_plan_is_legal(case):
    """Within the card's shared memory, the tile grid covers every output
    column once, each level's staged rows and columns are clamped into
    [0, n - 1], and every tap of every tile -- ragged ones included --
    falls inside the staged span; buffers do not overlap."""
    B, C, Y, X, Z, dims, tail, itemsize, K = PLAN_CASES[case]
    p = K8.plan_occ(B, C, Y, X, Z, dims, tail, itemsize, K)
    assert p.smem <= K8.SMEM_LIMIT
    gx, gy, gz = p.grid
    assert gz == B * p.groups and p.groups * p.chunks * p.CC >= C
    assert (p.groups - 1) * p.chunks * p.CC < C
    cover = np.zeros((Y, X), int)
    for ty in range(gy):
        for tx in range(gx):
            cover[ty * p.TY:(ty + 1) * p.TY, tx * p.TX:(tx + 1) * p.TX] += 1
    assert (cover == 1).all()
    regions = []
    for (ny, nx, nz), lv in zip(dims, p.levels):
        if lv.s0 < 0:
            assert lv.f == (1, 1, 1) and not tail
            continue
        for T, f, n, s, out in ((p.TY, lv.f[0], ny, lv.sy, Y),
                                (p.TX, lv.f[1], nx, lv.sx, X)):
            assert s == K8.span(T, f)
            for t0 in range(0, out, T):
                lo = K8.span_lo(t0, f)
                staged = [min(max(lo + i, 0), n - 1) for i in range(s)]
                assert all(0 <= r < n for r in staged)
                for o in range(t0, t0 + T):
                    i0, i1, _ = K8.tap(min(o, out - 1), f, n, lo)
                    assert 0 <= i0 < s and 0 <= i1 < s
                    # the staged row there is the coarse row the tap means
                    ref = K8.tap(min(o, out - 1), f, n, 0)
                    assert staged[i0] == ref[0] and staged[i1] == ref[1]
        chs = K8.buffer_strides(lv.f, nz, lv.sy, lv.sx, p.TY, K8.r8(Z),
                                tail, itemsize)
        size = {"s0": 2 * p.CC * chs[0], "s1": p.CC * chs[1],
                "s2": p.CC * chs[2]}
        for key in ("s0", "s1", "s2"):
            off = getattr(lv, key)
            if off >= 0:
                assert off % 16 == 0
                regions.append((off, off + size[key] * itemsize))
        regions.append((lv.tap, lv.tap + (p.TY + p.TX + K8.r8(Z)) * 16))
    regions.sort()
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
    assert regions[-1][1] <= p.smem


def test_occ_plan_at_the_flagship():
    """The flagship plans: the blend 8 x 16 tiles, 8 channels a chunk, 4
    channel groups (1300 tiles); the tail 8 x 8 tiles, one k16 slice a
    chunk, every level staged (625 tiles); channel strides padded to 4
    (mod 32) words."""
    blend = K8.plan_occ(1, 128, 200, 200, 16, FLAGSHIP, False, 2)
    assert (blend.TY, blend.TX, blend.CC, blend.groups, blend.chunks) == \
        (8, 16, 8, 4, 4)
    assert blend.grid == (13, 25, 4) and blend.levels[0].s0 == -1
    tail = K8.plan_occ(1, 64, 200, 200, 16, FLAGSHIP, True, 2, 19)
    assert (tail.TY, tail.TX, tail.CC, tail.groups, tail.chunks) == \
        (8, 8, 16, 1, 4)
    assert tail.grid == (25, 25, 1)
    assert all(lv.s0 >= 0 for lv in tail.levels)
    for n in (24, 100, 1000, 1536):
        for itemsize in (2, 4):
            s = K8.pad_ch(n, itemsize)
            assert s >= n and s * itemsize // 4 % 32 == 4


def test_occ_plan_mirrors_the_kernel():
    """The Python plan's constants and layout are the kernel's."""
    with open(CU) as f:
        src = f.read()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kBlendThreads"] == K8.BLEND_THREADS
    assert const["kTailThreads"] == K8.TAIL_THREADS
    assert const["kMaxLevels"] == K8.MAX_LEVELS
    assert const["kMaxK"] == K8.MAX_K
    assert const["kZV"] == K8.ZV
    assert const["kMT"] == K8.MT
    assert const["kTailCC"] == K8.TAIL_CC
    assert const["kScratchLd"] == K8.SCRATCH_LD
    assert const["kPlanHead"] == K8.PLAN_HEAD
    assert const["kPlanLevel"] == K8.PLAN_LEVEL
    assert str(K8.SMEM_LIMIT) in src
    # the padding and the Tap record the plan assumes
    assert "(w + ((4 - w) & 31)) * 4 / es" in src
    assert re.search(r"struct Tap \{\s*int i0, i1;\s*float w0, w1;", src)
    p = K8.plan_occ(1, 64, 200, 200, 16, FLAGSHIP, True, 2, 19)
    assert len(p.ints()) == K8.PLAN_HEAD + K8.PLAN_LEVEL * 4


@pytest.mark.parametrize("kw", [dict(K=33), dict(Z=2048, C=4)])
def test_occ_plan_refuses(kw):
    """K > 32, and a layout past the card's shared memory, raise."""
    args = dict(B=1, C=64, Y=16, X=16, Z=16, K=19)
    args.update(kw)
    Z = args["Z"]
    dims = [(16 // f, 16 // f, Z // f) for f in (1, 2, 4, 8)]
    with pytest.raises(ValueError):
        K8.plan_occ(args["B"], args["C"], 16, 16, Z, dims, "K" in kw, 4,
                    args["K"])


# ---------------------------------------------------------------- emulation
def _round(v, dt):
    """A Python-float weight as the kernel's tap table holds it: (float)
    then rounded to the levels' type."""
    return torch.tensor(float(np.float32(v)), dtype=torch.float32).to(dt)


def _lerp_axis(v, dim, outs, f, n, lo, dt):
    """Lerp ``v`` along ``dim`` to the output coordinates ``outs`` with the
    kernel's taps (indices local to ``lo``): R(R(w0 * a) + R(w1 * b))."""
    if f == 1:
        return v
    parts = []
    for o in outs:
        i0, i1, w = K8.tap(o, f, n, lo)
        a, b = v.select(dim, i0), v.select(dim, i1)
        parts.append(_round(1.0 - w, dt) * a + _round(w, dt) * b)
    return torch.stack(parts, dim)


def _emulate(levels, w, tail, K=0):
    """The kernel's decomposition, tile by tile: (B, C, Y, X, Z) blend in
    the levels' type (before the affine)."""
    dt = levels[0].dtype
    B, C = levels[0].shape[:2]
    Y, X, Z = w.shape[2:]
    dims = [tuple(lv.shape[2:]) for lv in levels]
    p = K8.plan_occ(B, C, Y, X, Z, dims, tail, levels[0].element_size(), K)
    out = torch.empty(B, C, Y, X, Z, dtype=dt)
    zs = range(Z)
    for ty in range(p.grid[1]):
        for tx in range(p.grid[0]):
            y0, x0 = ty * p.TY, tx * p.TX
            ys = [min(y0 + i, Y - 1) for i in range(p.TY)]
            xs = [min(x0 + i, X - 1) for i in range(p.TX)]
            acc = None
            for l, (lv, pl) in enumerate(zip(levels, p.levels)):
                (ny, nx, nz), (fy, fx, fz) = dims[l], pl.f
                if pl.s0 < 0:       # read from global memory
                    v = lv[:, :, ys][:, :, :, xs]
                else:               # the clamped neighbourhood, staged
                    loy, lox = K8.span_lo(y0, fy), K8.span_lo(x0, fx)
                    rows = [min(max(loy + i, 0), ny - 1)
                            for i in range(pl.sy)]
                    cols = [min(max(lox + i, 0), nx - 1)
                            for i in range(pl.sx)]
                    v = lv[:, :, rows][:, :, :, cols]
                    zl = (lambda v: _lerp_axis(v, 4, zs, fz, nz, 0, dt))
                    yl = (lambda v: _lerp_axis(v, 2, ys, fy, ny, loy, dt))
                    v = yl(zl(v)) if tail else zl(yl(v))
                    v = _lerp_axis(v, 3, xs, fx, nx, lox, dt)
                t = v * w[:, l:l + 1][:, :, ys][:, :, :, xs]
                acc = t if acc is None else acc + t
            ny_, nx_ = min(p.TY, Y - y0), min(p.TX, X - x0)
            out[:, :, y0:y0 + ny_, x0:x0 + nx_] = acc[:, :, :ny_, :nx_]
    return out


EMU_CASES = {  # (B, C, Y, X, Z, factors): flagship factors, ragged tiles
    # at B = 2, a level of different factors by axis, coarse levels only
    "flagship_factors": (1, 5, 16, 24, 16, (1, 2, 4, 8)),
    "ragged": (2, 3, 20, 28, 16, (1, 2, 4)),
    "mixed_factors": (1, 3, 20, 28, 16, (1, (2, 1, 4), (1, 4, 2),
                                        (4, 2, 1))),
    "coarse_only": (1, 2, 16, 24, 8, ((2, 2, 2), (8, 4, 8))),
}


def _inputs(seed, B, C, Y, X, Z, factors, dt):
    rng = np.random.RandomState(seed)
    levels = [torch.from_numpy(rng.randn(B, C, *d).astype(np.float32)).to(dt)
              for d in _dims(Y, X, Z, factors)]
    w = torch.softmax(torch.from_numpy(
        rng.randn(B, len(levels), Y, X, Z).astype(np.float32)), 1).to(dt)
    return levels, w


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_emulated_blend_is_the_plain_blend(case, dtype):
    """The tiled separable decomposition, each op rounded to the type, is
    the plain versions' blend bit for bit: K9's (Y, Z, X order) and K8's
    before its affine (Z, Y, X order)."""
    B, C, Y, X, Z, factors = EMU_CASES[case]
    levels, w = _inputs(3, B, C, Y, X, Z, factors, dtype)
    got9 = _emulate(levels, w, tail=False)
    assert torch.equal(got9, K9.fuse_multiscale_plain(levels, w))
    got8 = _emulate(levels, w, tail=True, K=19)
    want8 = K8.blend(K8.upsample(levels, (Y, X, Z),
                                 (K8._Z, K8._Y, K8._X)), w)
    assert torch.equal(got8, want8)


def _emulated_tail(levels, w, a, b, k2):
    """K8 on the CPU as the kernel computes it: the emulated blend, the
    rounded affine and relu, the class product summed in f32 one k16
    chunk at a time over the zero-padded classes, and the first argmax of
    the rounded logits of the classes < K."""
    dt = levels[0].dtype
    C, K = k2.shape
    h = _emulate(levels, w, tail=True, K=K)
    c = (slice(None),) + (None,) * 3
    h = torch.relu(h * a.to(dt)[c] + b.to(dt)[c])
    hf = h.permute(0, 2, 3, 4, 1).float()
    kp = torch.zeros(C, -(-K // 8) * 8)
    kp[:, :K] = k2.to(dt).float()
    acc = torch.zeros(*hf.shape[:-1], kp.shape[1])
    for c0 in range(0, C, K8.TAIL_CC):
        acc = acc + hf[..., c0:c0 + K8.TAIL_CC] @ kp[c0:c0 + K8.TAIL_CC]
    logits = acc[..., :K].to(dt)
    return logits.float().argmax(-1), logits


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_emulated_tail_matches_plain_and_tpu_kernel(dtype):
    """The emulated K8 against its plain version -- logits within one
    rounding of the type (2^-7 of max(1, |logit|) in bf16, 1e-5 in f32;
    f32 sums in another order), labels on >= 99.9% of voxels -- and
    against the TPU kernel (interpret) on the JAX caller's Z and Y
    upsamples, with ``test_k8_plain_matches_occ_tail``'s tolerances."""
    levels, w = _inputs(5, 1, 40, 16, 12, 8, (1, 2, 4), dtype)
    rng = np.random.RandomState(6)
    a = torch.from_numpy(rng.rand(40).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(40).astype(np.float32))
    k2 = torch.from_numpy(rng.randn(40, 19).astype(np.float32))
    labels, logits = _emulated_tail(levels, w, a, b, k2)
    wl, wlg = K8.occ_tail_plain(levels, w, a, b, k2, return_logits=True)
    tol = 2.0 ** -7 if dtype == BF16 else 1e-5
    d = (logits.float() - wlg.float()).abs() / wlg.float().abs().clamp(min=1)
    assert d.max().item() <= tol
    assert (labels == wl).float().mean().item() >= 0.999
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jl = []
    for lv in levels:
        v = jnp.asarray(lv.float().permute(0, 2, 3, 4, 1).numpy(), jdt)
        for ax, size in ((3, 8), (1, 16)):
            if v.shape[ax] != size:
                v = jlayers._upsample_int_axis(v, ax, size // v.shape[ax])
        jl.append(v)
    want = np.asarray(jtail.occ_tail(
        jl, jnp.asarray(w.float().permute(0, 2, 3, 4, 1).numpy(), jdt),
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
        jnp.asarray(k2.numpy()), interpret=True).astype(jnp.float32))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    d = np.abs(logits.float().numpy() - want) / np.maximum(np.abs(want), 1)
    assert d.max() <= tol, d.max()
    agree = (labels.numpy() == want.argmax(-1)).mean()
    assert agree >= (0.999 if dtype == torch.float32 else 0.99), agree


def test_padded_classes_never_win_the_emulated_argmax():
    """All logits negative: the zero logits of the padding (K = 19 -> 24)
    stay out of the argmax, which keeps the first of equal logits."""
    levels, w = _inputs(7, 1, 16, 8, 8, 16, (1, 2), BF16)
    a, b = torch.ones(16), torch.full((16,), 0.5)
    k2 = -torch.rand(16, 19, generator=torch.Generator().manual_seed(1)) \
        - 0.1
    labels, logits = _emulated_tail(levels, w, a, b, k2)
    assert logits.float().max().item() < 0 and labels.max().item() < 19
    tie = torch.zeros(16, 19)      # every logit 0: the first class wins
    labels, _ = _emulated_tail(levels, w, a, b, tie)
    assert (labels == 0).all()


# ---------------------------------------------------------------- bf16x2
def _bf16_bits(u16):
    return torch.from_numpy(u16.astype(np.int16)).view(BF16)


def _rounded_from_f64(x):
    """float64 values rounded to nearest even bf16 (no detour via f32)."""
    x = np.asarray(x, np.float64)
    out = np.zeros_like(x)
    fin = np.isfinite(x) & (x != 0)
    _, e = np.frexp(x[fin])
    q = np.ldexp(1.0, np.maximum(e - 8, -133))     # 8 significant bits
    out[fin] = np.rint(x[fin] / q) * q             # rint: ties to even
    out[~fin] = x[~fin]
    with np.errstate(over="ignore"):   # past the bf16 range: inf
        return torch.from_numpy(out.astype(np.float32)).to(BF16)


def test_bf16_pair_ops_round_once():
    """The kernel's mul.rn / add.rn.bf16x2 round the exact result once;
    the plain versions compute in f32 and round.  Over 10^6 seeded pairs
    and edge cases (signed zeros, subnormals, powers of two, opposite
    signs, exponent gaps 8-20) both give the correctly rounded bf16 of
    the exact sum and product (taken in float64, exact for these)."""
    rng = np.random.RandomState(0)
    n = 1_000_000
    bits = rng.randint(0, 1 << 16, size=(2, n)).astype(np.uint16)
    exp = (bits >> 7) & 0xFF
    bits[exp == 0xFF] &= 0x807F          # no inf / nan: finite operands
    a, b = (_bf16_bits(v) for v in bits)
    # edge cases: signed zeros, subnormals, powers of two, opposite signs
    special = [0.0, -0.0, 2.0 ** -133, -2.0 ** -133, 2.0 ** -126,
               1.0, -1.0, 2.0, 0.5, 3.0, 1.0 + 2 ** -7, -(1.0 + 2 ** -7),
               2.0 ** 100, -2.0 ** 100, 2.0 ** -100]
    sa, sb = np.meshgrid(special, special)
    gaps = []   # x and +-(1 + m / 128) * 2^-gap x, gap 8..20
    for gap in range(8, 21):
        for m in (0, 1, 64, 127):
            for sign in (1, -1):
                for x in (1.0, 1.0 + 2 ** -7, 1.5, 1.9921875):
                    gaps.append((x, sign * (1 + m / 128) * 2.0 ** -gap * x))
    ga, gb = np.array(gaps).T
    ea = torch.tensor(np.concatenate([sa.ravel(), ga]), dtype=torch.float32)
    eb = torch.tensor(np.concatenate([sb.ravel(), gb]), dtype=torch.float32)
    a = torch.cat([a, ea.to(BF16)])
    b = torch.cat([b, eb.to(BF16)])
    af, bf = a.float(), b.float()
    a64, b64 = af.double().numpy(), bf.double().numpy()
    for f32, f64 in (((af + bf), a64 + b64), ((af * bf), a64 * b64)):
        got = f32.to(BF16).float()
        want = _rounded_from_f64(f64).float()
        fin = torch.isfinite(want)
        assert torch.equal(got[fin], want[fin])
        # and the sign of a zero result
        z = fin & (want == 0)
        assert torch.equal(torch.signbit(got[z]), torch.signbit(want[z]))
