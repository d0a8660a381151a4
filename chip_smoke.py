#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fbbev_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds every kernel of the serving path from ``fbbev_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel).
3. Holds each kernel against its plain PyTorch version at the flagship
   shapes (numpy-seeded inputs; K3 also at the BEV self-attention shapes)
   and times kernel, plain version and, where one exists, a single
   PyTorch library call.
4. Runs the full-width flagship ``FixedRigPipeline`` (FB-OCC R50 16f,
   bf16, random weights from a seeded ``torch.Generator``) over a stream
   of frames -- a sequence start, then small ego motion -- checks labels
   and logits, and that every kernel launched on every frame.
5. Runs a small bf16 config on the card and on the CPU (the kernels'
   plain versions) and requires the labels to agree.
6. Holds K7 (the 3x3 conv) against its plain version, forward and input
   gradient, at every shape the flagship train step gives it -- the
   image trunk's 2D convs and the z-slabs of the 3x3x3 convs -- in bf16
   and (at three shapes) f32, and times kernel, plain version and cuDNN.
7. Trains the full-width flagship (bf16, K7 on, ResNet stages
   checkpointed, random weights from a seeded ``torch.Generator``) on a
   synthetic batch: 3 steps of fresh streams, then 3 continuing steps
   carrying the temporal state; checks losses, gradients in every
   module, moved params / BatchNorm statistics / EMA, and that K7 -- and
   none of K1-K3 -- launched in forward and backward; prints ms per step
   and peak device memory.

Prints one ``{"kernels": [...]}`` line, then, last, the ``{"ok": true,
...}`` device line.  Any failure raises and exits non-zero.

``python3 chip_smoke.py --profile`` instead builds the kernels and prints
the flagship frame time and its per-stage and per-kernel device times,
then the flagship train step's time and its device time by kernel.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 CUDA-core
# FLOP/s, bf16 tensor-core FLOP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12

FRAMES = 6
TRAIN_STEPS = (3, 3)  # fresh-stream steps, then continuing steps

# K7's launches in one forward pass of the flagship (pallas_conv.supports
# holds): (N, H, W, Cin, Cout) and how many launches have that shape.
# First the 21 image-trunk 2D convs at 6 cameras -- ResNet-50 layer1-4
# (3 + 3 + 5 + 2), the FPN output conv, the depth net's reduce conv and
# its three basic blocks; then the three z-slabs, N = Z slices each, of
# the 16 stride-1 3x3x3 convs -- 3D ResNet stages 0-2 (4 + 3 + 3), FPN3D
# (one per level) and the occ head (one per level, 256 -> 128).
K7_SHAPES = [((6, 64, 176, 64, 64), 3), ((6, 32, 88, 128, 128), 3),
             ((6, 16, 44, 256, 256), 6), ((6, 8, 22, 512, 512), 2),
             ((6, 16, 44, 256, 512), 1), ((6, 16, 44, 512, 512), 6),
             ((8, 100, 100, 64, 64), 12), ((4, 50, 50, 128, 128), 9),
             ((2, 25, 25, 256, 256), 12), ((8, 100, 100, 256, 256), 3),
             ((4, 50, 50, 256, 256), 3), ((8, 100, 100, 256, 128), 3),
             ((4, 50, 50, 256, 128), 3), ((2, 25, 25, 256, 128), 3)]
K7_RESNET_LAUNCHES = 13  # recomputed in the backward of checkpointed stages


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, iters=20, warmup=3):
    """Mean ms per call with CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes, f32_flops=0.0, tc_flops=0.0):
    t_bytes = nbytes / HBM_BPS
    t_ops = f32_flops / F32_FLOPS + tc_flops / BF16_TC_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flagship_rig(N=6, H=256, W=704):
    """A nuScenes-like 6-camera rig at the flagship input size."""
    from fbbev_tpu_torch import geometry
    import torch
    yaws = np.deg2rad([55.0, 0.0, -55.0, 110.0, 180.0, -110.0])[:N]
    rots, trans, intr = [], [], []
    for n, th in enumerate(yaws):
        fwd = [np.cos(th), np.sin(th), 0.0]
        right = [np.sin(th), -np.cos(th), 0.0]
        rots.append(np.stack([right, [0.0, 0.0, -1.0], fwd], 1))
        trans.append([0.9 * np.cos(th), 0.9 * np.sin(th), 1.6])
        f = 350.0 if n == 4 else 560.0
        intr.append([[f, 0, W / 2], [0, f, H / 2 - 50], [0, 0, 1]])
    t = (lambda a: torch.tensor(np.asarray(a, np.float32)))
    return geometry.CamParams(
        rots=t(rots)[None], trans=t(trans)[None], intrins=t(intr)[None],
        post_rots=t(np.tile(np.eye(3), (1, N, 1, 1))),
        post_trans=t(np.zeros((1, N, 3))), bda=t(np.eye(3))[None])


def flow(step):
    th = 0.01 * step
    c2p = np.eye(4, dtype=np.float32)
    c2p[0, 0] = c2p[1, 1] = np.cos(th)
    c2p[0, 1], c2p[1, 0] = -np.sin(th), np.sin(th)
    c2p[0, 3], c2p[1, 3] = 0.5, 0.05
    return c2p[None]


def entry(name, src, replaces, err, tol, ms, plain_ms, b, library_ms):
    log(f"{name}: max_abs_err {err:.3e} (tol {tol:.1e})  kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b[0]:.4f} ms "
        f"({b[1]})  library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version: {err} > {tol}")
    return dict(name=name, route="cuda", source=src, replaces=replaces,
                launches=0, max_abs_err=float(err), ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                library_ms=library_ms)


def check_k2(dev):
    """K2 at the flagship rig: depth (1,6,80,16,44), feat (1,6,16,44,80)."""
    import torch
    from fbbev_tpu_torch import geometry, host_lib
    from fbbev_tpu_torch.models.lss import LSSViewTransformer3D
    from fbbev_tpu_torch.models.fbocc import DEFAULT_GRID_CONFIG
    from fbbev_tpu_torch.ops import pallas_pool as K2
    fp = LSSViewTransformer3D(DEFAULT_GRID_CONFIG, (256, 704), 16)
    coor = geometry.frustum_to_ego(torch.from_numpy(fp.frustum),
                                   flagship_rig()).numpy().reshape(-1, 3)
    ranks = host_lib.compute_voxel_ranks(
        coor, np.zeros(len(coor), np.int32), fp.grid_lower,
        fp.grid_interval, fp.grid_size, 1)
    plan = K2.plan_pool(ranks, 1, 6, fp.D, 16, 44, fp.grid_size).to(dev)
    rng = np.random.RandomState(2)
    d = rng.rand(1, 6, 80, 16, 44).astype(np.float32)
    depth = torch.from_numpy(d / d.sum(2, keepdims=True)).to(dev)
    feat = torch.from_numpy(rng.randn(1, 6, 16, 44, 80).astype(
        np.float32)).to(dev)
    got = K2.lss_voxel_pool_planned(plan, depth, feat)
    want = K2.lss_voxel_pool_precomputed(plan.ranks, depth, feat,
                                         fp.grid_size)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ms = cuda_time(lambda: K2.lss_voxel_pool_planned(plan, depth, feat))
    plain_ms = cuda_time(lambda: K2.lss_voxel_pool_precomputed(
        plan.ranks, depth, feat, fp.grid_size))
    prod = (depth[..., None] * feat[:, :, None]).reshape(-1, 80)
    acc = torch.zeros(prod.shape[0] + 1, 80, device=dev)
    library_ms = cuda_time(lambda: acc.index_add_(0, plan.ranks, prod))
    pv, niv = plan.pt_depth.numel(), plan.iv_out.numel()
    nbytes = (depth.numel() + feat.numel() + got.numel()) * 4 \
        + pv * 8 + niv * 12
    log(f"K2: {pv} valid points of {ranks.size}, {niv} voxel intervals")
    return entry("bev_pool", "fbbev_tpu_torch/csrc/bev_pool.cu",
                 "fbbev_tpu/ops/pallas_pool.py:207", err, 1e-4, ms,
                 plain_ms, bound(nbytes, f32_flops=2.0 * pv * 80),
                 library_ms)


def check_k3(dev, name, B, HW, hw, Q, P):
    """K3 with a bf16 value map (B, HW, 8, 10)."""
    import torch
    from fbbev_tpu_torch.ops import pallas_sample as K3
    rng = np.random.RandomState(3)
    value = torch.from_numpy(rng.randn(B, HW, 8, 10).astype(
        np.float32)).to(dev, torch.bfloat16)
    loc = torch.from_numpy(rng.uniform(-0.05, 1.05, (B, Q, 8, P, 2)).astype(
        np.float32)).to(dev)
    attn = torch.softmax(torch.from_numpy(rng.randn(B, Q, 8, P).astype(
        np.float32)), -1).to(dev)
    got = K3.deformable_sample_attend(value, hw, loc, attn)
    want = K3.deformable_sample_attend_plain(value, hw, loc, attn)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ms = cuda_time(lambda: K3.deformable_sample_attend(value, hw, loc, attn))
    plain_ms = cuda_time(lambda: K3.deformable_sample_attend_plain(
        value, hw, loc, attn))
    nbytes = value.numel() * 2 + (loc.numel() + attn.numel()
                                  + got.numel()) * 4
    return entry(name, "fbbev_tpu_torch/csrc/msda.cu",
                 "fbbev_tpu/ops/pallas_sample.py:165" if name == "msda"
                 else "fbbev_tpu/ops/pallas_selfattn.py:198", err, 1e-4,
                 ms, plain_ms, bound(nbytes, f32_flops=got.numel() * P * 4
                                     * 2.0), None)


def check_k1(dev, epilogue=True):
    """K1 at the flagship: hist (1,8,100,100,1280) bf16, curr
    (1,100,100,8,80) bf16, epilogue to F=160."""
    import torch
    from fbbev_tpu_torch import geometry
    from fbbev_tpu_torch.ops import pallas_fuse_warp as K1
    rng = np.random.RandomState(4)
    B, Z, Y, X, C, T, F = 1, 8, 100, 100, 80, 16, 160
    t = (lambda a, dt=torch.float32: torch.from_numpy(
        np.asarray(a, np.float32)).to(dev, dt))
    hist = t(rng.randn(B, Z, Y, X, T * C), torch.bfloat16)
    curr = t(rng.randn(B, Y, X, Z, C), torch.bfloat16)
    dx, bx, _ = geometry.gen_dx_bx((-40, 40, 0.8), (-40, 40, 0.8),
                                   (-1, 5.4, 0.8))
    f2b = t(geometry.feat2bev_matrix(dx, bx))
    eye = torch.eye(4, device=dev)[None]
    mat = geometry.flow_matrix_from_grid_args(eye, eye, t(flow(1)), f2b)
    start = torch.zeros(B, dtype=torch.bool, device=dev)
    hsel = torch.tensor([5], device=dev)
    epi = None
    if epilogue:
        epi = dict(kc=t(rng.randn(C, C) / np.sqrt(C)),
                   ke=t(rng.randn(C) * 0.1), kb=t(rng.randn(C) * 0.1),
                   tvec=t(rng.rand(B, T) * 8.0),
                   ws=t(rng.randn(B, T * C, F) / np.sqrt(T * C),
                        torch.bfloat16))
    got, gh = K1.fuse_warp(hist, curr, mat, start, hsel, epilogue=epi)
    want, wh = K1.fuse_warp_plain(hist, curr, mat, start, hsel,
                                  epilogue=epi)
    torch.cuda.synchronize()
    # the warp and ring update do the same f32 operations in the same
    # order in both versions: expected bit-identical; one bf16 ulp allowed
    hd = (gh.float() - wh.float()).abs()
    log(f"K1 new history: {int((hd > 0).sum())} of {hd.numel()} elements "
        f"differ, max {hd.max().item():.3e}")
    if hd.max().item() > 2.0 ** -7 * wh.float().abs().max().item():
        raise AssertionError("K1 new history differs from the plain version")
    err = (got.float() - want.float()).abs().max().item()
    ms = cuda_time(lambda: K1.fuse_warp(hist, curr, mat, start, hsel,
                                        epilogue=epi), iters=10)
    plain_ms = cuda_time(lambda: K1.fuse_warp_plain(
        hist, curr, mat, start, hsel, epilogue=epi), iters=3, warmup=1)
    V = B * Z * Y * X
    nbytes = (hist.numel() + curr.numel() + gh.numel()) * 2 + \
        got.numel() * got.element_size()
    warp_flops = 2.0 * 8 * V * T * C
    tc = 0.0
    if epilogue:
        nbytes += (epi["ws"].numel()) * 2 + C * C * 2
        tc = 2.0 * V * T * C * (C + F)
    # epilogue: f32 sums in another order can move y1 across a bf16
    # rounding boundary (1 ulp = 2^-8 relative) before the 1280-row
    # product; without it the slots are the bf16 warp (one ulp allowed)
    tol = 2e-2 if epilogue else 2.0 ** -7 * want.float().abs().max().item()
    return entry("fuse_warp" if epilogue else "fuse_warp_noepi",
                 "fbbev_tpu_torch/csrc/fuse_warp.cu",
                 "fbbev_tpu/ops/pallas_fuse_warp.py:280", err, tol, ms,
                 plain_ms,
                 bound(nbytes, f32_flops=warp_flops, tc_flops=tc), None)


def unported_bounds(dev):
    """Bounds of the TPU kernels not ported yet (K4-K6, K8-K10), from the
    flagship shapes: bf16 activations, f32 where the TPU kernel keeps f32;
    bytes = inputs read once + outputs written once.  K5 and K6 also get
    the time of the one PyTorch call that computes their function."""
    def conv(n, v, cin, cout, k, bpe=2):
        # n convs over v output voxels/pixels each, k taps
        return (n * (v * (cin + cout) * bpe + k * cin * cout * bpe),
                n * 2.0 * v * k * cin * cout)
    rows = []
    # K4: BEV self-attention, value (1,10000,8,10) bf16, loc/attn f32, P=4
    q = 10000
    rows.append(("K4 pallas_selfattn", q * 80 * 2 + q * 32 * 3 * 4
                 + q * 80 * 4, 0.0, q * 80 * 4 * 4 * 2.0))
    # K5: warp alone, (1,8,100,100,1280) bf16 in and out, 8 taps
    v = 8 * 100 * 100
    rows.append(("K5 pallas_warp", 2 * v * 1280 * 2, 0.0,
                 v * 1280 * 8 * 2.0))
    # K6: the stride-1 3x3x3 convs of the 3D encoder, FPN3D and occ head
    c6 = [conv(4, 80000, 64, 64, 27), conv(3, 10000, 128, 128, 27),
          conv(3, 1250, 256, 256, 27), conv(1, 80000, 256, 256, 27),
          conv(1, 10000, 256, 256, 27), conv(1, 1250, 256, 256, 27),
          conv(1, 80000, 256, 128, 27), conv(1, 10000, 256, 128, 27),
          conv(1, 1250, 256, 128, 27)]
    rows.append(("K6 pallas_conv3d", sum(c[0] for c in c6),
                 sum(c[1] for c in c6), 0.0))
    # K8: occ tail, four 64-ch levels (bf16, native sizes) + blend weights
    # (1,200,200,16,4) -> logits (1,200,200,16,19) f32
    full = 200 * 200 * 16
    lv = full + 80000 + 10000 + 1250
    rows.append(("K8 pallas_occ_tail", lv * 64 * 2 + full * 4 * 2
                 + full * 19 * 4, full * 64 * 19 * 2.0,
                 full * 4 * 64 * 8 * 2.0))
    # K9: upsample + blend of four 128-ch levels -> (1,200,200,16,128) bf16
    rows.append(("K9 pallas_occ_fuse", lv * 128 * 2 + full * 4 * 2
                 + full * 128 * 2, 0.0, full * 4 * 128 * 8 * 2.0))
    # K10: K3's math from precomputed corners (4 x int32 index + f32
    # weight per sample) at the cross-attention shapes
    s3 = 6 * 4096 * 8 * 8
    rows.append(("K10 pallas_deform", 6 * 704 * 80 * 2 + s3 * 4 * 8
                 + s3 * 4 + 6 * 4096 * 80 * 4, 0.0,
                 6 * 4096 * 80 * 8 * 4 * 2.0))
    for name, nbytes, tc, f32 in rows:
        b = bound(nbytes, f32_flops=f32, tc_flops=tc)
        log(f"bound {name}: {b[0]:.4f} ms ({b[1]}; {nbytes / 1e6:.1f} MB, "
            f"{(tc + f32) / 1e9:.2f} GFLOP)")
    library_k5_k6(dev)


def library_k5_k6(dev):
    """Library yardsticks of two unported kernels: K5's warp as one 5-D
    ``F.grid_sample`` (align_corners=True) of the bf16 history on a
    precomputed grid, and K6's stride-1 3x3x3 convs as ``F.conv3d``
    (cuDNN, bf16, channels-last) at the path's shapes and counts."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(7)
    hist = torch.randn(1, 1280, 8, 100, 100, generator=g).to(
        dev, torch.bfloat16)
    grid = (torch.rand(1, 8, 100, 100, 3, generator=g) * 2 - 1).to(dev)
    ms = cuda_time(lambda: F.grid_sample(
        hist, grid.to(hist.dtype), mode="bilinear", padding_mode="zeros",
        align_corners=True), iters=10)
    log(f"library K5 F.grid_sample 5-D bf16 (1,1280,8,100,100): {ms:.4f} ms")
    # (count, Y, X, Z, Cin, Cout) of the 3D encoder, FPN3D and occ head
    c6 = [(4, 100, 100, 8, 64, 64), (3, 50, 50, 4, 128, 128),
          (3, 25, 25, 2, 256, 256), (1, 100, 100, 8, 256, 256),
          (1, 50, 50, 4, 256, 256), (1, 25, 25, 2, 256, 256),
          (1, 100, 100, 8, 256, 128), (1, 50, 50, 4, 256, 128),
          (1, 25, 25, 2, 256, 128)]
    total = 0.0
    for n, Y, X, Z, ci, co in c6:
        x = torch.randn(1, ci, Y, X, Z, generator=g).to(
            dev, torch.bfloat16).contiguous(
                memory_format=torch.channels_last_3d)
        w = (torch.randn(co, ci, 3, 3, 3, generator=g) / (27 * ci) ** 0.5
             ).to(dev, torch.bfloat16).contiguous(
                 memory_format=torch.channels_last_3d)
        total += n * cuda_time(lambda: F.conv3d(x, w, padding=1), iters=10)
    log(f"library K6 F.conv3d bf16, the path's 16 3x3x3 s1 convs: "
        f"{total:.4f} ms")


def check_k7(dev):
    """K7 forward and input gradient at every shape of ``K7_SHAPES``, bf16
    (and f32 at three shapes), against the plain version; times of
    kernel, plain version and cuDNN (``F.conv2d`` / ``conv2d_input``).
    Returns the forward and dgrad entries, their times summed over the
    launches of one pass.  Tolerance: bf16 2e-2 of max(1, |value|) --
    both sum in f32 and round once to bf16, so a sum in another order may
    move an output by one bf16 ulp (2^-7 relative); f32 1e-4 absolute on
    O(1) outputs (f32 sums of 9*Cin products in another order).  The
    entries carry the largest absolute bf16 error (``max_abs_err``,
    against 2e-2 of max(1, max |value|)) and the largest relative one
    (``max_rel_err``)."""
    import torch
    import torch.nn.functional as F
    from fbbev_tpu_torch.ops import pallas_conv as K7
    g = torch.Generator().manual_seed(8)
    tot = {k: 0.0 for k in ("ms", "plain", "lib", "dms", "dplain", "dlib",
                            "bytes", "flops")}
    err = {k: {"abs": 0.0, "tol": 0.0, "rel": 0.0}
           for k in ("fwd", "dgrad")}
    for (N, H, W, ci, co), count in K7_SHAPES:
        for dt in ((torch.bfloat16, torch.float32)
                   if (H, ci) in ((64, 64), (16, 512), (25, 256)) else
                   (torch.bfloat16,)):
            cl = torch.channels_last
            x = torch.randn(N, ci, H, W, generator=g).to(dev, dt).contiguous(
                memory_format=cl)
            w = (torch.randn(co, ci, 3, 3, generator=g) * 0.5
                 / (9 * ci) ** 0.5).to(dev, dt)
            gy = torch.randn(N, co, H, W, generator=g).to(dev, dt).contiguous(
                memory_format=cl)
            wt = w.flip(2, 3).transpose(0, 1)
            with torch.no_grad():
                pairs = ((K7.conv3x3_s1(x, w), K7.conv3x3_s1_plain(x, w)),
                         (K7._dgrad(gy, w), K7.conv3x3_s1_plain(gy, wt)))
            torch.cuda.synchronize()
            for kind, (got, want) in zip(("fwd", "dgrad"), pairs):
                got, want = got.float(), want.float()
                d = (got - want).abs()
                if dt == torch.bfloat16:
                    e = (d / want.abs().clamp(min=1.0)).max().item()
                    tol, how = 2e-2, "relative"
                    r = err[kind]
                    r["abs"] = max(r["abs"], d.max().item())
                    r["tol"] = max(r["tol"], tol * max(
                        1.0, want.abs().max().item()))
                    r["rel"] = max(r["rel"], e)
                else:
                    e, tol, how = d.max().item(), 1e-4, "absolute"
                log(f"K7 {kind} {str(dt)[6:]} N={N} {H}x{W} {ci}->{co}: "
                    f"{how} err {e:.3e} (tol {tol:.0e}; absolute "
                    f"{d.max().item():.3e})")
                if not e <= tol:
                    raise AssertionError(f"K7 {kind} differs from its plain "
                                         f"version: {e} > {tol}")
            if dt != torch.bfloat16:
                continue
            with torch.no_grad():
                t = [cuda_time(lambda: K7.conv3x3_s1(x, w), iters=10),
                     cuda_time(lambda: K7.conv3x3_s1_plain(x, w), iters=5),
                     cuda_time(lambda: F.conv2d(x, w, padding=1), iters=10),
                     cuda_time(lambda: K7._dgrad(gy, w), iters=10),
                     cuda_time(lambda: K7.conv3x3_s1_plain(gy, wt), iters=5),
                     cuda_time(lambda: torch.nn.grad.conv2d_input(
                         x.shape, w, gy, padding=1), iters=10)]
            log(f"K7 N={N} {H}x{W} {ci}->{co} x{count}: fwd kernel "
                f"{t[0]:.4f} plain {t[1]:.4f} cuDNN {t[2]:.4f} ms; dgrad "
                f"kernel {t[3]:.4f} plain {t[4]:.4f} cuDNN {t[5]:.4f} ms")
            for k, v in zip(("ms", "plain", "lib", "dms", "dplain", "dlib"),
                            t):
                tot[k] += count * v
            tot["bytes"] += count * (x.numel() + gy.numel() + w.numel()) * 2
            tot["flops"] += count * 2.0 * N * H * W * 9 * ci * co
    b = bound(tot["bytes"], tc_flops=tot["flops"])
    n = sum(c for _, c in K7_SHAPES)
    log(f"K7 over the {n} launches of one pass: fwd {tot['ms']:.4f} ms "
        f"(cuDNN {tot['lib']:.4f}), dgrad {tot['dms']:.4f} ms (cuDNN "
        f"{tot['dlib']:.4f}), bound {b[0]:.4f} ms each ({b[1]})")
    src = "fbbev_tpu_torch/csrc/conv3x3.cu"
    out = []
    for name, kind, line, ms, plain, lib in (
            ("conv3x3", "fwd", 67, "ms", "plain", "lib"),
            ("conv3x3_dgrad", "dgrad", 145, "dms", "dplain", "dlib")):
        e = err[kind]
        out.append(entry(name, src, f"fbbev_tpu/ops/pallas_conv.py:{line}",
                         e["abs"], e["tol"], tot[ms], tot[plain], b,
                         tot[lib]))
        out[-1]["max_rel_err"] = e["rel"]
    return out


def train_batch(dev, g, model, cam, start, step):
    """A synthetic training batch for ``model`` on rig ``cam``: random
    images, ``gt_occupancy`` at the logits' size (1,200,200,16 at the
    flagship) with 30% of voxels at 255, and sparse ``gt_depth`` (1, N,
    H, W), 10% of pixels at 1-45 m."""
    import torch
    N = cam.trans.shape[1]
    H, W = model.input_size
    nx, ny, nz = model.forward_projection.grid_size
    occ = torch.randint(0, 19, (1, 2 * ny, 2 * nx, 2 * nz), generator=g)
    occ = torch.where(torch.rand(occ.shape, generator=g) < 0.3, 255, occ)
    depth = torch.rand(1, N, H, W, generator=g) * 44.0 + 1.0
    depth = torch.where(torch.rand(depth.shape, generator=g) < 0.9, 0.0,
                        depth)
    b = dict(imgs=torch.randn(1, N, H, W, 3, generator=g),
             **cam._asdict(),
             start_of_sequence=torch.tensor([start]),
             sequence_group_idx=torch.zeros(1, dtype=torch.int32),
             curr_to_prev_ego_rt=torch.from_numpy(flow(0 if start else step)),
             gt_occupancy=occ, gt_depth=depth)
    return {k: v.to(dev) for k, v in b.items()}


def run_train(dev):
    """The flagship train step at full width in bf16 with K7 and stage
    checkpointing: TRAIN_STEPS fresh-stream then continuing steps.
    Returns (launch counts, ms per step, peak GiB)."""
    import torch
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.models.fbocc import init_temporal_state
    from fbbev_tpu_torch.ops import pallas_conv, pallas_fuse_warp, \
        pallas_pool, pallas_sample
    from fbbev_tpu_torch.train import Trainer
    t0 = time.perf_counter()
    model = FBOCC(dtype=torch.bfloat16, device=dev, pallas3x3=True,
                  remat=True, generator=torch.Generator().manual_seed(0))
    cam = flagship_rig()
    trainer = Trainer(model)
    s0 = trainer.init_state()
    tstate = init_temporal_state(1, model.forward_projection.grid_size,
                                 model.history_cat_num,
                                 model.single_bev_num_channels,
                                 dtype=model.dtype, device=dev)
    g = torch.Generator().manual_seed(9)
    n_fresh, n_cont = TRAIN_STEPS
    batches = [train_batch(dev, g, model, cam, i < n_fresh, i)
               for i in range(n_fresh + n_cont)]
    log(f"train: model, trainer and {len(batches)} batches built in "
        f"{time.perf_counter() - t0:.1f} s")
    mods = (pallas_conv, pallas_fuse_warp, pallas_pool, pallas_sample)
    for m in mods:
        m.launches = 0
    pallas_conv.dgrad_launches = 0
    pallas_sample.selfattn_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, ms = s0, []
    for i, batch in enumerate(batches):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, tstate, met = trainer.train_step(state, tstate, batch,
                                                do_history=i >= n_fresh)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        met = {k: float(v) for k, v in met.items()}
        log(f"train step {i} (do_history={i >= n_fresh}): {ms[-1]:.1f} ms "
            + " ".join(f"{k}={v:.4f}" for k, v in met.items()))
        if not all(np.isfinite(v) for v in met.values()):
            raise AssertionError(f"non-finite metrics: {met}")
        if met["seq_mismatch"] != 0:
            raise AssertionError("sequence mismatch in a continuing step")
        if i == 0:
            # Adam's first moment is 0.1 * the clipped gradient: every
            # top-level module got a finite non-zero gradient
            mu = trainer.unflatten(state.opt_state.mu)
            for top in sorted({n.split(".")[0] for n in mu}):
                norm = float(torch.sqrt(sum(
                    (v.float() ** 2).sum() for n, v in mu.items()
                    if n.split(".")[0] == top)))
                if not (np.isfinite(norm) and norm > 0):
                    raise AssertionError(f"no gradient reaches {top}: {norm}")
                log(f"  gradient (Adam mu) norm {top}: {norm:.4e}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = dict(conv3x3=pallas_conv.launches,
                  conv3x3_dgrad=pallas_conv.dgrad_launches,
                  bev_pool=pallas_pool.launches,
                  msda=pallas_sample.launches,
                  msda_selfattn=pallas_sample.selfattn_launches,
                  fuse_warp=pallas_fuse_warp.launches)
    log(f"launches in the train run: {counts}")
    # every K7 conv of K7_SHAPES once forward and once in dgrad per step,
    # the ResNet's again in its stages' recomputation
    per_pass = sum(c for _, c in K7_SHAPES)
    want = (len(batches) * (per_pass + K7_RESNET_LAUNCHES),
            len(batches) * per_pass)
    if (counts["conv3x3"], counts["conv3x3_dgrad"]) != want:
        raise AssertionError(f"K7 launches (forward, dgrad) "
                             f"{counts['conv3x3'], counts['conv3x3_dgrad']}"
                             f", expected {want}")
    if counts["bev_pool"] or counts["msda"] or counts["msda_selfattn"] \
            or counts["fuse_warp"]:
        raise AssertionError(f"training launched a kernel without a "
                             f"backward: {counts}")
    for what, a, b in (("params", s0.params, state.params),
                       ("batch_stats", s0.batch_stats, state.batch_stats),
                       ("ema_params", s0.ema_params, state.ema_params),
                       ("ema_batch_stats", s0.ema_batch_stats,
                        state.ema_batch_stats)):
        moved = float((a != b).float().mean())
        log(f"  {what}: {moved:.4f} of the elements moved")
        if moved == 0.0:
            raise AssertionError(f"{what} did not move")
    steady = float(np.median(ms[1:]))
    log(f"flagship train step: {steady:.1f} ms per step (median of steps "
        f"2..{len(ms)}, CUDA events; first step {ms[0]:.1f} ms), peak "
        f"device memory {peak:.2f} GiB")
    return counts, steady, peak


def run_flagship(dev):
    """Full-width flagship serving stream in bf16."""
    import torch
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.ops import pallas_fuse_warp, pallas_pool, \
        pallas_sample
    from fbbev_tpu_torch.serving import FixedRigPipeline
    t0 = time.perf_counter()
    model = FBOCC(dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    pipe = FixedRigPipeline(model, flagship_rig())
    log(f"flagship model + rig-static terms built in "
        f"{time.perf_counter() - t0:.1f} s")
    logits = []
    model.occupancy_head.occ_pred_conv[3].register_forward_hook(
        lambda m, i, o: logits.append(bool(torch.isfinite(o).all()))
        or None)
    g = torch.Generator().manual_seed(1)
    imgs = [torch.randn(1, 6, 256, 704, 3, generator=g).to(dev)
            for _ in range(FRAMES)]
    for m in (pallas_pool, pallas_sample, pallas_fuse_warp):
        m.launches = 0
    pallas_sample.selfattn_launches = 0
    times = []
    for i in range(FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = pipe(imgs[i], i == 0, flow(0 if i == 0 else 1))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    counts = dict(bev_pool=pallas_pool.launches, msda=pallas_sample.launches,
                  msda_selfattn=pallas_sample.selfattn_launches,
                  fuse_warp=pallas_fuse_warp.launches)
    log(f"flagship frames: {FRAMES}, ms per frame "
        f"{[round(x, 2) for x in times]}, median "
        f"{float(np.median(times)):.2f} ms (first frame included)")
    log(f"launches in the stream: {counts}")
    if tuple(labels.shape) != (1, 200, 200, 16):
        raise AssertionError(f"labels shape {tuple(labels.shape)}")
    if not (len(logits) == FRAMES and all(logits)):
        raise AssertionError(f"non-finite logits: {logits}")
    lab = labels.flatten().bincount(minlength=19).tolist()
    log(f"labels of the last frame by class: {lab}")
    if not (counts["bev_pool"] == counts["fuse_warp"] == counts["msda"]
            == counts["msda_selfattn"] == FRAMES):
        raise AssertionError(f"a kernel missed a frame: {counts}")
    return counts, float(np.median(times[1:]))


def run_small_parity(dev):
    """A small bf16 config on the card (kernels, cuDNN) vs the same model
    on the CPU (plain versions, oneDNN): labels must agree on >= 95% of
    voxels (bf16 convolutions round differently in the two libraries, and
    random-weight logits have near-ties)."""
    import torch
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.serving import FixedRigPipeline
    kw = dict(grid_config={"x": (-40.0, 40.0, 4.0), "y": (-40.0, 40.0, 4.0),
                           "z": (-1.0, 5.4, 0.8), "depth": (2.0, 42.0, 0.5)},
              bevformer_grid_config={"x": (-40.0, 40.0, 4.0),
                                     "y": (-40.0, 40.0, 4.0),
                                     "z": (-1.0, 5.4, 1.6)},
              input_size=(64, 128), num_cams=2, history_cat_num=2,
              single_bev_num_channels=64, history_cat_conv_out_channels=128,
              depth_mid_channels=64, voxel_channels=(16, 32, 64),
              voxel_out_channels=32, max_queries_per_cam=256)
    rig = flagship_rig(N=2, H=64, W=128)
    out = {}
    for d in ("cpu", dev):
        m = FBOCC(**kw, dtype=torch.bfloat16, device=d,
                  generator=torch.Generator().manual_seed(5))
        pipe = FixedRigPipeline(m, rig)
        g = torch.Generator().manual_seed(6)
        out[d] = [pipe(torch.randn(1, 2, 64, 128, 3, generator=g), i == 0,
                       flow(i)).cpu() for i in range(3)]
    agree = min(float((a == b).float().mean())
                for a, b in zip(out["cpu"], out[dev]))
    log(f"small bf16 config, card vs CPU plain versions: label agreement "
        f"{agree:.5f} (min over 3 frames)")
    if agree < 0.95:
        raise AssertionError(f"card and CPU disagree: {agree}")


def profile(dev, frames=5):
    """Flagship frame time and its device time by stage and by kernel
    (``--profile``): 20 timed frames, then ``torch.profiler`` over
    ``frames`` frames; then the same with cuDNN's autotuner on."""
    import torch
    from torch.profiler import ProfilerActivity
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.serving import FixedRigPipeline
    model = FBOCC(dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    pipe = FixedRigPipeline(model, flagship_rig())
    g = torch.Generator().manual_seed(1)
    imgs = [torch.randn(1, 6, 256, 704, 3, generator=g).to(dev)
            for _ in range(3)]
    pipe(imgs[0], True)
    ours = ("bev_pool_kernel", "msda_kernel", "fuse_warp_kernel")
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        ms = cuda_time(lambda: pipe(imgs[1], False, flow(1)), iters=20)
        log(f"cudnn.benchmark={bench}: flagship steady frame {ms:.3f} ms "
            f"(CUDA events, mean of 20)")
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(frames):
                pipe(imgs[i % 3], False, flow(1))
            torch.cuda.synchronize()
        ev = prof.key_averages()
        dkey = ("device_time_total" if hasattr(ev[0], "device_time_total")
                else "cuda_time_total")
        dt = (lambda e: getattr(e, dkey) / 1e3 / frames)
        cuda = torch.autograd.DeviceType.CUDA
        kern = [e for e in ev if e.device_type == cuda
                and not e.key.startswith("serving/")]
        total = sum(dt(e) for e in kern)
        log(f"  kernel time per frame {total:.3f} ms of {ms:.3f} ms: "
            f"device idle share {max(0.0, 1 - total / ms):.3f}")
        # a stage's device time: kernels launched by its PyTorch ops; the
        # port's own kernels (launched through ctypes) are listed apart
        for e in sorted((e for e in ev if e.key.startswith("serving/")
                         and e.device_type != cuda), key=dt, reverse=True):
            log(f"  stage {e.key[8:]:22s} {dt(e):8.3f} ms device (torch "
                f"ops)  {e.cpu_time_total / 1e3 / frames:8.3f} ms host")
        for e in sorted(kern, key=dt, reverse=True)[:16]:
            tag = "port" if any(o in e.key for o in ours) else "    "
            log(f"  {tag} kernel {dt(e):8.3f} ms x{e.count // frames:<3d} "
                f"{e.key[:80]}")
    torch.backends.cudnn.benchmark = False
    # the depth net's convolutions one by one, at their frame inputs
    shapes = {}

    def record(m, inputs, output):
        shapes.setdefault(m, (inputs[0].shape, inputs[0].stride()))

    hooks = [m.register_forward_hook(record)
             for m in model.depth_net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    pipe(imgs[1], False, flow(1))
    for h in hooks:
        h.remove()
    rows = []
    for name, m in model.depth_net.named_modules():
        if m in shapes:
            shape, stride = shapes[m]
            x = torch.empty_strided(shape, stride, device=dev,
                                    dtype=torch.bfloat16).normal_()
            with torch.no_grad():
                rows.append((cuda_time(lambda: m(x), iters=5), name, m))
    for ms, name, m in sorted(rows, key=lambda r: r[0], reverse=True)[:6]:
        log(f"  depth_net conv {ms:8.3f} ms  {name}: {m}")


def profile_train(dev, steps=3):
    """The flagship train step (bf16, checkpointed stages) with K7 and with
    cuDNN for the same convolutions (``pallas3x3`` on / off, the same
    weights), timed in turns (cuDNN, K7, K7, cuDNN; CUDA events, mean of
    ``steps`` after two warm-up steps), then the K7 step under
    ``torch.profiler``: kernel time per step, device idle share, the top
    kernels and K7's share (``--profile``)."""
    import torch
    from torch.profiler import ProfilerActivity
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.models.fbocc import init_temporal_state
    from fbbev_tpu_torch.train import Trainer
    runs = {}
    for k7 in (False, True):
        model = FBOCC(dtype=torch.bfloat16, device=dev, pallas3x3=k7,
                      remat=True, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model)
        tstate = init_temporal_state(1, model.forward_projection.grid_size,
                                     model.history_cat_num,
                                     model.single_bev_num_channels,
                                     dtype=model.dtype, device=dev)
        batch = train_batch(dev, torch.Generator().manual_seed(9), model,
                            flagship_rig(), False, 1)
        runs[k7] = [trainer, trainer.init_state(), tstate, batch]

    def step(k7):
        r = runs[k7]
        r[1], r[2], _ = r[0].train_step(r[1], r[2], r[3])

    times = {False: [], True: []}
    for k7 in (False, True, True, False):
        times[k7].append(cuda_time(lambda: step(k7), iters=steps, warmup=2))
        log(f"flagship train step, {'K7' if k7 else 'cuDNN'} convs: "
            f"{times[k7][-1]:.3f} ms (CUDA events, mean of {steps})")
    del runs[False]
    ms = float(np.mean(times[True]))
    with torch.profiler.profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(True)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    dkey = ("device_time_total" if hasattr(ev[0], "device_time_total")
            else "cuda_time_total")
    dt = (lambda e: getattr(e, dkey) / 1e3 / steps)
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in ev if e.device_type == cuda]
    total = sum(dt(e) for e in kern)
    k7 = sum(dt(e) for e in kern if "conv3x3_" in e.key)
    log(f"flagship train step with K7 {ms:.3f} ms (mean of the two "
        f"turns); kernel time {total:.3f} ms: device idle share "
        f"{max(0.0, 1 - total / ms):.3f}; K7 {k7:.3f} ms")
    for e in sorted(kern, key=dt, reverse=True)[:20]:
        log(f"  train kernel {dt(e):8.3f} ms x{e.count // steps:<4d} "
            f"{e.key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from fbbev_tpu_torch.ops import _cuda
    log(nvidia_smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # full-f32 references: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    libs = _cuda.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for so in libs.values():
        with open(so + ".log") as f:
            ptx = [ln.strip() for ln in f if "registers" in ln]
        log(f"  {os.path.basename(so)}: {' | '.join(ptx)}")
    if "--profile" in sys.argv[1:]:
        profile(dev)
        profile_train(dev)
        return 0

    # the JSON line lists each kernel once, at its main-path shapes; the
    # same kernels at their other shapes / variant are checked and logged
    kernels = [check_k2(dev),
               check_k3(dev, "msda", 6, 16 * 44, (16, 44), 4096, 8),
               check_k3(dev, "msda_selfattn", 1, 10000, (100, 100), 10000,
                        4),
               check_k1(dev, epilogue=True)]
    check_k1(dev, epilogue=False)
    k7 = check_k7(dev)
    unported_bounds(dev)
    counts, median_ms = run_flagship(dev)
    log(f"flagship median frame {median_ms:.2f} ms (frames 2..{FRAMES})")
    for k in kernels:
        k["launches"] = counts[k["name"]]
    run_small_parity(dev)
    train_counts, step_ms, peak = run_train(dev)
    for k in k7:
        k["launches"] = train_counts[k["name"]]
    log(json.dumps({"kernels": kernels + k7}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
