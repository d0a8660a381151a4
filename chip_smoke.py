#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fbbev_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds every kernel of the serving path from ``fbbev_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel).
3. Holds each kernel against its plain PyTorch version at the flagship
   shapes (numpy-seeded inputs; K2 with f32 and bf16 features; K3 also at
   the BEV self-attention shapes) and times kernel, plain version and,
   where one exists, a single PyTorch library call (K2 also from a CUDA
   graph and in host microseconds per call).
4. Runs the full-width flagship ``FixedRigPipeline`` (FB-OCC R50 16f,
   bf16, random weights from a seeded ``torch.Generator``) over a stream
   of frames -- a sequence start, then small ego motion -- checks labels
   and logits, and that every kernel launched on every frame.
5. Runs a small bf16 config on the card and on the CPU (the kernels'
   plain versions) and requires the labels to agree.
6. Holds K7 (the 3x3 conv) against its plain version, forward and input
   gradient, at every shape the flagship train step gives it -- the
   image trunk's 2D convs and the z-slabs of the 3x3x3 convs -- in bf16
   and (at three shapes) f32, and its bf16 weight gradient against the
   f32 one; times kernel, plain version and cuDNN per call and from a
   CUDA graph, the weight gradient three ways, and the host time per call.
7. Trains the full-width flagship (bf16, K7 on, ResNet stages
   checkpointed, random weights from a seeded ``torch.Generator``) on a
   synthetic batch: 3 steps of fresh streams, then 3 continuing steps
   carrying the temporal state; checks losses, gradients in every
   module, moved params / BatchNorm statistics / EMA, and that K7 -- and
   none of the serving kernels -- launched in forward and backward; prints
   ms per step and peak device memory.
8. Holds K5 (the age-ordered history warp), K6 (the 3x3x3 conv), K8 (the
   occ tail) and K9 (the occ blend) against their plain versions at the
   flagship shapes, bf16 and f32 (K5 also bit for bit against K1's
   one-slot plain warp; K8 also its labels-only launch against its logits
   launch), and times kernel, plain version and library call (K5, K6, K8
   and K9 also from a CUDA graph).  Runs two more full-width
   streams with the model's route arguments: ``fuse_warp=False,
   pallas_conv3d=True, occ_tail=True``
   (6 frames: K2, K3 twice, K5, K6 sixteen times and K8 per frame, no K1)
   and ``coarse_pred=False, occ_fuse=True`` (3 frames: K1 and K9 per
   frame), each with its launch counts set to 0 just before it and read
   just after, and the small card-vs-CPU label check for the first.
9. Holds K10 (deformable sampling from precomputed corners, the JAX
   package's drop-in op, on no model path: 0 launches in every stream)
   against its plain version at K3's cross-attention shapes, bf16 and f32
   maps, and times it per call, from a CUDA graph and under each of its
   plans (the corner rows through a ring in shared memory, or loaded
   directly).
10. The config-built serving entry (``run_config``): the flagship built
    from ``fbbev_tpu_torch/configs/fbocc-r50-cbgs_depth_16f.py`` through
    ``train.loop.build_model`` with perturbed BatchNorms, folded and
    unfolded, 5 frames each (label agreement, exact launch counts);
    ``FixedRigPipeline.benchmark`` on the folded one; the single-frame
    config with K1 at T = 1 held against its plain version; the float32
    tiny config on the card and on the CPU, with K1's f32 kernel held
    against its plain version; and both benchmark tools' JSON lines
    (``fbbev_tpu_torch/tools``), each with exact launch counts.
11. The training and evaluation loop (``run_loop``): the flagship smoke
    config (``fbocc-r50_synthetic_smoke.py``) trained through
    ``train.loop.train`` with K7 for 6 iterations, resumed from its
    checkpoint to 12 (the restored checkpoint equal bit for bit to the
    state saved), evaluated from the latest checkpoint on 4 samples,
    then ``tools.train`` and ``tools.test``, each with exact launch
    counts; prints ms per iteration, peak memory, checkpoint bytes and
    save / restore seconds, eval seconds per sample.  Its work dir is a
    temporary directory, deleted at the end.

Prints one ``{"kernels": [...]}`` line, then, last, the ``{"ok": true,
...}`` device line.  Any failure raises and exits non-zero.

``python3 chip_smoke.py --profile`` instead builds the kernels and prints
the flagship frame time and its per-stage and per-kernel device times, for
the kernel-routed configuration and the default one, then the flagship
train step's time and its device time by kernel; ``--profile-default``
the default configuration alone; ``--profile-occ`` the routed and blend
streams, those that take K8 and K9 (copied beside an older tree's
package, it profiles that package).  ``--k6-plans`` and ``--k7-plans`` time
every tile plan of K6's and K7's bf16 kernels at their flagship shapes.
``--config`` runs the config phase (10.) alone, ``--loop`` the loop
phase (11.).
``--k1`` builds the kernels, prints the ``-Xptxas -v`` lines of
``fuse_warp.cu``'s kernels, holds K1 (both variants) and K5 against their
plain versions at the flagship (K5 also bit for bit against K1's one-slot
plain warp), times them and every K5 plan and exits; ``--msda`` does the
same for K3, K4 and K10 (``msda.cu``); ``--pool`` for K2 (``bev_pool.cu``,
with its plans' tile sizes); ``--occ``
does the same for K9 and K8 (bf16 and f32; timed per call and from a
CUDA graph, with their tile plans) after printing the ``-Xptxas -v``
lines of ``occ_tail.cu``'s kernels (registers, spills).
"""

import json
import os
import re
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
T0 = time.perf_counter()
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


def graph_time(fn, reps=10, replays=5):
    """Mean ms per call of ``reps`` calls captured in one CUDA graph and
    replayed ``replays`` times (CUDA events): the device time of the calls
    without the host's per-call launch cost."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


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


def flagship_pool_inputs(dev):
    """K2's flagship rig: its ranks (337,920 points), depth (1,6,80,16,44)
    normalised over the bins, feat (1,6,16,44,80) f32, from seed 2."""
    import torch
    from fbbev_tpu_torch import geometry, host_lib
    from fbbev_tpu_torch.models.lss import LSSViewTransformer3D
    from fbbev_tpu_torch.models.fbocc import DEFAULT_GRID_CONFIG
    fp = LSSViewTransformer3D(DEFAULT_GRID_CONFIG, (256, 704), 16)
    coor = geometry.frustum_to_ego(torch.from_numpy(fp.frustum),
                                   flagship_rig()).numpy().reshape(-1, 3)
    ranks = host_lib.compute_voxel_ranks(
        coor, np.zeros(len(coor), np.int32), fp.grid_lower,
        fp.grid_interval, fp.grid_size, 1)
    rng = np.random.RandomState(2)
    d = rng.rand(1, 6, 80, 16, 44).astype(np.float32)
    depth = torch.from_numpy(d / d.sum(2, keepdims=True)).to(dev)
    feat = torch.from_numpy(rng.randn(1, 6, 16, 44, 80).astype(
        np.float32)).to(dev)
    return ranks, fp, depth, feat


def check_k2(dev, sweep=False):
    """K2 at the flagship rig: depth (1,6,80,16,44) f32, feat
    (1,6,16,44,80) f32 and bf16, each within 1e-4 of the plain version
    (f32 sums in another order); timed per call, from a CUDA graph and in
    host microseconds per call, beside the output's ``torch.zeros`` and
    ``torch.empty`` alone.  The JSON entry is the bf16 run's, the serving
    path's feature type.  Its bound counts the bytes the kernel moves:
    depth, feat, the output, the row pointers, the points and the tiles,
    each once; PR 9's formula (f32 feat, its interval table's two indices
    a point and three ints an occupied row) is printed beside it for
    comparison.  With ``sweep`` plans of other tile sizes are checked and
    timed."""
    import torch
    from fbbev_tpu_torch.ops import pallas_pool as K2
    ranks, fp, depth, feat = flagship_pool_inputs(dev)
    grid = fp.grid_size
    plan = K2.plan_pool(ranks, 1, 6, fp.D, 16, 44, grid).to(dev)
    feats = {"f32": feat, "bf16": feat.to(torch.bfloat16)}
    wants = {name: K2.lss_voxel_pool_precomputed(plan.ranks, depth,
                                                 ft.float(), grid)
             for name, ft in feats.items()}
    times = {}
    for name, ft in feats.items():
        got = K2.lss_voxel_pool_planned(plan, depth, ft)
        torch.cuda.synchronize()
        e = (got - wants[name]).abs().max().item()
        if not e <= 1e-4:
            raise AssertionError(f"K2 {name}: {e} > 1e-4")
        call = (lambda ft=ft: K2.lss_voxel_pool_planned(plan, depth, ft))
        times[name] = (e, cuda_time(call, iters=50), graph_time(call,
                                                                reps=20),
                       host_us(call))
        log(f"K2 feat {name}: max_abs_err {e:.3e}, {times[name][1]:.4f} ms "
            f"per call, {times[name][2]:.4f} ms from a graph, "
            f"{times[name][3]:.1f} us host per call")
    out_elems = wants["f32"].numel()
    shape = (1, grid[1], grid[0], grid[2], 80)
    zeros_ms = graph_time(lambda: torch.zeros(shape, device=dev), reps=20)
    empty_us = host_us(lambda: torch.empty(shape, device=dev))
    log(f"K2 output alone: torch.zeros {zeros_ms:.4f} ms from a graph; "
        f"torch.empty {empty_us:.1f} us host per call")
    fbf = feats["bf16"]
    _, ms, gms, hus = times["bf16"]
    err = max(t[0] for t in times.values())
    plain_ms = cuda_time(lambda: K2.lss_voxel_pool_precomputed(
        plan.ranks, depth, fbf.float(), grid))
    prod = (depth[..., None] * fbf.float()[:, :, None]).reshape(-1, 80)
    acc = torch.zeros(prod.shape[0] + 1, 80, device=dev)
    library_ms = cuda_time(lambda: acc.index_add_(0, plan.ranks, prod))
    rows = out_elems // 80
    pv = int((ranks < rows).sum())
    niv = np.unique(ranks[ranks < rows]).size
    log(f"K2: {pv} valid points of {ranks.size}, {niv} occupied rows of "
        f"{rows}; {plan.work.numel()} tiles of at most {K2.TILE_ROWS} rows "
        f"and {K2.TILE_POINTS} points, {plan.n_long} long rows")
    tables = sum(t.numel() * 4 for t in (plan.row_ptr, plan.pts, plan.work))
    moved = {name: (depth.numel() + out_elems) * 4 + tables
             + ft.numel() * ft.element_size() for name, ft in feats.items()}
    pr9 = (depth.numel() + feat.numel() + out_elems) * 4 + pv * 8 + niv * 12
    log("K2 bytes moved: " + ", ".join(
        f"{k} {n} ({1e3 * n / HBM_BPS:.5f} ms)" for k, n in
        (("feat f32", moved["f32"]), ("feat bf16", moved["bf16"]),
         ("PR 9's formula", pr9))) + f" at {HBM_BPS / 1e12:.2f} TB/s")
    if sweep:
        for tr, tp in ((8, 32), (16, 32), (16, 64), (31, 64), (16, 128),
                       (31, 128)):
            p = K2.plan_pool(ranks, 1, 6, fp.D, 16, 44, grid, rows=tr,
                             points=tp).to(dev)
            row = []
            for name, ft in feats.items():
                e = (K2.lss_voxel_pool_planned(p, depth, ft)
                     - wants[name]).abs().max().item()
                if not e <= 1e-4:
                    raise AssertionError(f"K2 plan {tr}/{tp} {name}: {e}")
                t = graph_time(lambda ft=ft, p=p:
                               K2.lss_voxel_pool_planned(p, depth, ft),
                               reps=20)
                row.append(f"{name} {t:.4f}")
            log(f"K2 plan: tiles of {tr} rows / {tp} points "
                f"({p.work.numel()} tiles, {p.n_long} long rows): ms from "
                f"a graph {', '.join(row)}")
    out = entry("bev_pool", "fbbev_tpu_torch/csrc/bev_pool.cu",
                "fbbev_tpu/ops/pallas_pool.py:207", err, 1e-4, ms,
                plain_ms, bound(moved["bf16"], f32_flops=2.0 * pv * 80),
                library_ms)
    out.update(graph_ms=gms, host_us=hus)
    return out


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
    call = (lambda: K3.deformable_sample_attend(value, hw, loc, attn))
    ms = cuda_time(call, iters=50)
    gms = graph_time(call, reps=20)
    plain_ms = cuda_time(lambda: K3.deformable_sample_attend_plain(
        value, hw, loc, attn))
    nbytes = value.numel() * 2 + (loc.numel() + attn.numel()
                                  + got.numel()) * 4
    plan = K3.plan_msda(B, HW, 8, 10, Q, P, value.dtype,
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count)
    log(f"{name} (B {B}, map {hw}, Q {Q}, P {P}): {ms:.4f} ms per call, "
        f"{gms:.4f} ms from a graph; plan {plan._asdict()}")
    out = entry(name, "fbbev_tpu_torch/csrc/msda.cu",
                "fbbev_tpu/ops/pallas_sample.py:165" if name == "msda"
                else "fbbev_tpu/ops/pallas_selfattn.py:198", err, 1e-4,
                ms, plain_ms, bound(nbytes, f32_flops=got.numel() * P * 4
                                    * 2.0), None)
    out.update(graph_ms=gms)
    return out


def check_k1(dev, epilogue=True, T=16):
    """K1 at the flagship: hist (1,8,100,100,80*T) bf16 (T = 16 history
    frames; 1 in the single-frame config), curr (1,100,100,8,80) bf16,
    epilogue to F=160.  Times per call (CUDA events around back-to-back
    calls, the wrapper's host time included) and replayed from a CUDA
    graph (``graph_ms``); with the epilogue the kernel's plan and its
    registers from ``-Xptxas -v``."""
    import torch
    from fbbev_tpu_torch import geometry
    from fbbev_tpu_torch.ops import _cuda
    from fbbev_tpu_torch.ops import pallas_fuse_warp as K1
    rng = np.random.RandomState(4)
    B, Z, Y, X, C, F = 1, 8, 100, 100, 80, 160
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
    hsel = torch.tensor([min(5, T - 1)], device=dev)
    epi = None
    if epilogue:
        epi = dict(kc=t(rng.randn(C, C) / np.sqrt(C)),
                   ke=t(rng.randn(C) * 0.1), kb=t(rng.randn(C) * 0.1),
                   tvec=t(rng.rand(B, T) * 8.0),
                   ws=t(rng.randn(B, T * C, F) / np.sqrt(T * C),
                        torch.bfloat16))
        plan = K1.plan_epilogue(B, Z, Y, X, C, F)
        with open(_cuda.build(["fuse_warp"])["fuse_warp"] + ".log") as f:
            regs = [r for r in ptxas_summary(f.read()).split(" | ")
                    if r.startswith("fuse_warp_epi")]
        log(f"K1 epilogue kernel: plan {plan._asdict()}; ptxas: "
            f"{' | '.join(regs)}")
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
    call = (lambda: K1.fuse_warp(hist, curr, mat, start, hsel, epilogue=epi))
    ms = cuda_time(call, iters=10)
    gms = graph_time(call)
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
    log(f"K1 {'with' if epilogue else 'without'} the epilogue at T={T}: "
        f"{ms:.4f} ms per call, {gms:.4f} ms from a graph")
    # epilogue: f32 sums in another order can move y1 across a bf16
    # rounding boundary (1 ulp = 2^-8 relative) before the 1280-row
    # product; without it the slots are the bf16 warp (one ulp allowed)
    tol = 2e-2 if epilogue else 2.0 ** -7 * want.float().abs().max().item()
    out = entry(("fuse_warp" if epilogue else "fuse_warp_noepi")
                + ("" if T == 16 else f"_t{T}"),
                "fbbev_tpu_torch/csrc/fuse_warp.cu",
                "fbbev_tpu/ops/pallas_fuse_warp.py:280", err, tol, ms,
                plain_ms,
                bound(nbytes, f32_flops=warp_flops, tc_flops=tc), None)
    out.update(graph_ms=gms)
    return out


def check_k10(dev):
    """K10 at K3's cross-attention shapes (B 6, 16x44 map, heads 8, hd 10,
    Q 4096, P 8), bf16 value map: the corner entry against its plain
    version on the same precomputed corners (tolerance 1e-4, as K3), and
    the drop-in equal to the corner entry; timed per call, from a CUDA
    graph and in host microseconds per call, then under its plan and with
    the corner rows loaded directly, each equal to the entry's result; the
    f32 map within 1e-4.  No path of the JAX package reaches K10 (its
    docstring: "the model uses the XLA path"), so it launches 0 times per
    frame; it is held here as the drop-in op it is.  Bound: bytes of the
    value map, the corner rows (int32 index + f32 weight per corner) and
    the output, once."""
    import torch
    from fbbev_tpu_torch.ops import pallas_deform as K10
    B, H, W, heads, hd, Q, P = 6, 16, 44, 8, 10, 4096, 8
    rng = np.random.RandomState(14)
    value = torch.from_numpy(rng.randn(B, H * W, heads, hd).astype(
        np.float32)).to(dev, torch.bfloat16)
    loc = torch.from_numpy(rng.uniform(-0.05, 1.05, (B, Q, heads, P, 2))
                           .astype(np.float32)).to(dev)
    attn = torch.softmax(torch.from_numpy(rng.randn(B, Q, heads, P).astype(
        np.float32)), -1).to(dev)
    idx, wgt = K10.corners(loc, attn, H, W)
    got = K10.deformable_sample_attend_corners(value, idx, wgt, heads, P)
    want = K10.deformable_sample_attend_corners_plain(value, idx, wgt, heads,
                                                      P)
    drop_in = K10.pallas_deformable_sample_attend(value, (H, W), loc, attn)
    torch.cuda.synchronize()
    if not torch.equal(drop_in, got):
        raise AssertionError("K10 drop-in differs from its corner entry")
    err = (got - want).abs().max().item()
    call = (lambda: K10.deformable_sample_attend_corners(value, idx, wgt,
                                                         heads, P))
    ms = cuda_time(call, iters=50)
    gms = graph_time(call, reps=20)
    hus = host_us(call)
    log(f"K10 (B {B}, map {(H, W)}, Q {Q}, P {P}): {ms:.4f} ms per call, "
        f"{gms:.4f} ms from a graph, {hus:.1f} us host per call")
    # each plan through the launch entry: the same sums in the same
    # order, so equal to the wrapper's; the f32 map within 1e-4
    for ring in (True, False):
        p = K10.plan_corners(B, H * W, heads, hd, Q, P, value.dtype,
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count, ring=ring)
        out = torch.full_like(got, float("nan"))
        status = K10._launch(value, idx, wgt, heads, P, out, p)
        torch.cuda.synchronize()
        if status != 0 or not torch.equal(out, got):
            raise AssertionError(f"K10 plan {p} differs")
        t = graph_time(lambda p=p, out=out: K10._launch(
            value, idx, wgt, heads, P, out, p), reps=20)
        log(f"K10 plan {p._asdict()}: {t:.4f} ms from a graph")
    v32 = value.float()
    e32 = (K10.deformable_sample_attend_corners(v32, idx, wgt, heads, P)
           - K10.deformable_sample_attend_corners_plain(
               v32, idx, wgt, heads, P)).abs().max().item()
    log(f"K10 f32 map: max_abs_err {e32:.3e} (tol 1.0e-04)")
    if not e32 <= 1e-4:
        raise AssertionError(f"K10 f32: {e32}")
    plain_ms = cuda_time(lambda: K10.deformable_sample_attend_corners_plain(
        value, idx, wgt, heads, P))
    nbytes = value.numel() * 2 + idx.numel() * 4 + wgt.numel() * 4 + \
        got.numel() * 4
    log("K10 pallas_deform: no path of the JAX package reaches it; 0 "
        "launches per frame in every stream")
    out = entry("pallas_deform", "fbbev_tpu_torch/csrc/msda.cu",
                "fbbev_tpu/ops/pallas_deform.py:61", err, 1e-4, ms,
                plain_ms, bound(nbytes, f32_flops=got.numel() * P * 4
                                * 2.0), None)
    out.update(graph_ms=gms, host_us=hus)
    return out


def flagship_flow_matrix(dev):
    """The flagship's (1, 4, 4) index-unit history flow for flow(1)."""
    import torch
    from fbbev_tpu_torch import geometry
    dx, bx, _ = geometry.gen_dx_bx((-40, 40, 0.8), (-40, 40, 0.8),
                                   (-1, 5.4, 0.8))
    f2b = torch.from_numpy(geometry.feat2bev_matrix(dx, bx)).to(dev)
    eye = torch.eye(4, device=dev)[None]
    c2p = torch.from_numpy(flow(1)).to(dev)
    return geometry.flow_matrix_from_grid_args(eye, eye, c2p, f2b)


def one_slot_warp(vol, mat):
    """K1's plain warp stage run as one slot: ``fuse_warp_plain`` with T =
    1, ``curr`` zeros, no sequence start and no slot overwritten -- the
    operations K5's kernel does, in the same order."""
    import torch
    from fbbev_tpu_torch.ops import pallas_fuse_warp as K1
    B, Z, Y, X, C = vol.shape
    curr = torch.zeros(B, Y, X, Z, C, dtype=vol.dtype, device=vol.device)
    start = torch.zeros(B, device=vol.device)
    hsel = torch.full((B,), -1, device=vol.device)
    return K1.fuse_warp_plain(vol, curr, mat, start, hsel)[0]


def rotation_flow_matrix(dev, theta=0.5, shift=7.0):
    """A (1, 4, 4) index-unit flow rotating the 100x100 grid by ``theta``
    rad about its centre and shifting it by ``shift`` cells: enough to
    send the tiles far from the centre to K5's fallback."""
    import torch
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[0, :2], m[1, :2] = (c, -s), (s, c)
    m[0, 3] = 49.5 - c * 49.5 + s * 49.5 + shift
    m[1, 3] = 49.5 - s * 49.5 - c * 49.5
    return torch.from_numpy(m[None]).to(dev)


def check_k5(dev, sweep=False):
    """K5 at the flagship: the age-ordered history (1,8,100,100,1280) bf16
    warped by flow(1) into (1,100,100,8,1280); f32 at 256 channels.  The
    kernel must equal K1's plain warp stage run as one slot bit for bit
    (``one_slot_warp``), under flow(1) and under a 0.5 rad rotation that
    sends tiles to the fallback.  Against ``warp_affine_3d_plain``
    (``grid_sample_3d``), tolerance: the kernel rounds each tent weight to
    the history type as the TPU kernel does, the plain version keeps it
    f32, both round the sum once: 2^-7 of the largest |history| in bf16;
    1e-3 in f32 (the kernel takes source coordinates in index units, the
    plain version through the [-1, 1] grid: f32 rounding moves a
    coordinate by ~1e-5 cells at 100 cells, times field slopes of up to
    ~10 per cell on random data).  Library: one 5-D ``F.grid_sample`` on
    the same history and the flow's grid.  Times per call and from a CUDA
    graph; with ``sweep`` every plan of ``WARP_PLANS``, each output equal
    to the default plan's."""
    import torch
    import torch.nn.functional as F
    from fbbev_tpu_torch import geometry
    from fbbev_tpu_torch.ops import pallas_warp as K5
    g = torch.Generator().manual_seed(10)
    mat = flagship_flow_matrix(dev)
    rot = rotation_flow_matrix(dev)
    for dt, C in ((torch.float32, 256), (torch.bfloat16, 1280)):
        vol = torch.randn(1, 8, 100, 100, C, generator=g).to(dev, dt)
        got = K5.warp_affine_3d(vol, mat)
        want = K5.warp_affine_3d_plain(vol, mat)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = (1e-3 if dt == torch.float32 else
               2.0 ** -7 * vol.float().abs().max().item())
        del want
        exact = [torch.equal(got, one_slot_warp(vol, mat)),
                 torch.equal(K5.warp_affine_3d(vol, rot),
                             one_slot_warp(vol, rot))]
        log(f"K5 {str(dt)[6:]} (1,8,100,100,{C}): max_abs_err {err:.3e} "
            f"(tol {tol:.1e}); equal to the one-slot plain warp under "
            f"flow(1) {exact[0]}, under the 0.5 rad rotation {exact[1]}")
        if not err <= tol:
            raise AssertionError(f"K5 differs from its plain version: {err}")
        if not all(exact):
            raise AssertionError("K5 differs from the one-slot plain warp")
    grid = geometry.flow_grid(mat, (8, 100, 100)).to(vol.dtype)
    volc = vol.permute(0, 4, 1, 2, 3)                  # (N, C, D, H, W)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = K5.WARP_PLANS if sweep else K5.WARP_PLANS[:1]
    for p in plans:
        out = K5.warp_affine_3d(vol, mat, plan=p)
        if not torch.equal(out, got):
            raise AssertionError(f"K5 plan {p} differs from the default's")
        call = (lambda: K5.warp_affine_3d(vol, mat, plan=p))
        pms, pgms = cuda_time(call, iters=20), graph_time(call)
        plan = K5.plan_warp(1, 8, 100, 100, 1280, vol.dtype, sms, p)
        log(f"K5 plan {plan._asdict()}: {pms:.4f} ms per call, {pgms:.4f} "
            f"ms from a graph")
        if p == K5.WARP_PLANS[0]:
            ms, gms = pms, pgms
    plain_ms = cuda_time(lambda: K5.warp_affine_3d_plain(vol, mat), iters=3,
                         warmup=1)
    library_ms = cuda_time(lambda: F.grid_sample(
        volc, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), iters=10)
    nbytes = 2 * vol.numel() * 2
    out = entry("warp_affine", "fbbev_tpu_torch/csrc/fuse_warp.cu",
                "fbbev_tpu/ops/pallas_warp.py:190", err, tol, ms, plain_ms,
                bound(nbytes, f32_flops=2.0 * 8 * vol.numel()), library_ms)
    out.update(graph_ms=gms)
    return out


# K6's convs in one flagship frame: (count, Y, X, Z, Cin, Cout) of the 3D
# ResNet (4 + 3 + 3), FPN3D (one per level) and the occ head (one per
# level, 256 -> 128)
K6_SHAPES = [(4, 100, 100, 8, 64, 64), (3, 50, 50, 4, 128, 128),
             (3, 25, 25, 2, 256, 256), (1, 100, 100, 8, 256, 256),
             (1, 50, 50, 4, 256, 256), (1, 25, 25, 2, 256, 256),
             (1, 100, 100, 8, 256, 128), (1, 50, 50, 4, 256, 128),
             (1, 25, 25, 2, 256, 128)]


def check_k6(dev):
    """K6 at each of its flagship shapes in bf16 (f32 at 25x25x2 256->256)
    against the plain version (``F.conv3d`` in f32, no TF32); times of
    kernel, plain version and cuDNN (``F.conv3d`` bf16, channels-last),
    summed over the 16 convs of one frame: per call (CUDA events around
    back-to-back calls, host launch cost included, as ``ms`` and
    ``library_ms``) and replayed from a CUDA graph (device time alone, as
    ``graph_ms`` and ``library_graph_ms``).  Tolerance: 2e-2 of max(1,
    |y|) in bf16 (both sum in f32 and round once), 1e-4 in f32;
    ``max_abs_err`` is the largest absolute bf16 error, held against 2e-2
    of max(1, max |y|)."""
    import torch
    import torch.nn.functional as F
    from fbbev_tpu_torch.ops import pallas_conv3d as K6
    g = torch.Generator().manual_seed(11)
    tot = dict(ms=0.0, plain=0.0, lib=0.0, gms=0.0, glib=0.0, bytes=0.0,
               flops=0.0)
    err_abs, tol_abs, rel = 0.0, 0.0, 0.0
    cl = torch.channels_last_3d
    for n, Y, X, Z, ci, co in K6_SHAPES:
        for dt in ((torch.bfloat16, torch.float32)
                   if (Y, ci, co) == (25, 256, 256) else (torch.bfloat16,)):
            x = torch.randn(1, ci, Y, X, Z, generator=g).to(
                dev, dt).contiguous(memory_format=cl)
            w = (torch.randn(co, ci, 3, 3, 3, generator=g)
                 / (27 * ci) ** 0.5).to(dev, dt)
            with torch.no_grad():
                got = K6.conv3d_3x3x3(x, w).float()
                want = K6.conv3d_3x3x3_plain(x, w).float()
            torch.cuda.synchronize()
            d = (got - want).abs()
            e = (d / want.abs().clamp(min=1.0)).max().item()
            tol = 2e-2 if dt == torch.bfloat16 else 1e-4
            log(f"K6 {str(dt)[6:]} {Y}x{X}x{Z} {ci}->{co}: relative err "
                f"{e:.3e} (tol {tol:.0e}; absolute {d.max().item():.3e})")
            if not e <= tol:
                raise AssertionError(f"K6 differs from its plain version: "
                                     f"{e} > {tol}")
            if dt != torch.bfloat16:
                continue
            err_abs = max(err_abs, d.max().item())
            tol_abs = max(tol_abs, tol * max(1.0, want.abs().max().item()))
            rel = max(rel, e)
            wl = w.contiguous(memory_format=cl)
            with torch.no_grad():
                t = [cuda_time(lambda: K6.conv3d_3x3x3(x, w), iters=10),
                     cuda_time(lambda: K6.conv3d_3x3x3_plain(x, w), iters=3,
                               warmup=1),
                     cuda_time(lambda: F.conv3d(x, wl, padding=1), iters=10),
                     graph_time(lambda: K6.conv3d_3x3x3(x, w)),
                     graph_time(lambda: F.conv3d(x, wl, padding=1))]
            flops = 2.0 * Y * X * Z * 27 * ci * co
            log(f"K6 {Y}x{X}x{Z} {ci}->{co} x{n} "
                f"{K6.plan_bf16(1, Y, X, Z, ci, co, K6._sms(x.device))}: "
                f"kernel {t[0]:.4f} plain {t[1]:.4f} cuDNN {t[2]:.4f} ms per "
                f"call; graph kernel {t[3]:.4f} ({flops / t[3] / 1e9:.1f} "
                f"TFLOP/s) cuDNN {t[4]:.4f} ms")
            for k, v in zip(("ms", "plain", "lib", "gms", "glib"), t):
                tot[k] += n * v
            tot["bytes"] += n * (x.numel() * (ci + co) / ci + w.numel()) * 2
            tot["flops"] += n * flops
    b = bound(tot["bytes"], tc_flops=tot["flops"])
    log(f"K6 over the 16 convs of a frame: kernel {tot['ms']:.4f} ms per "
        f"call, {tot['gms']:.4f} ms from a graph; cuDNN {tot['lib']:.4f} / "
        f"{tot['glib']:.4f} ms; bound {b[0]:.4f} ms ({b[1]}; "
        f"{tot['flops'] / 1e9:.1f} GFLOP)")
    out = entry("conv3d", "fbbev_tpu_torch/csrc/conv3d.cu",
                "fbbev_tpu/ops/pallas_conv3d.py:130", err_abs, tol_abs,
                tot["ms"], tot["plain"], b, tot["lib"])
    out.update(max_rel_err=rel, graph_ms=tot["gms"],
               library_graph_ms=tot["glib"])
    return out


def k6_plans(dev):
    """``--k6-plans``: at each distinct K6 shape, every legal tile plan of
    the bf16 kernel (``pallas_conv3d.plans_bf16``) checked against the
    plain version (2e-2 of max(1, |y|)) and timed from a CUDA graph,
    fastest first, with the model's rank and the plan it picks."""
    import torch
    from fbbev_tpu_torch.ops import _cuda
    from fbbev_tpu_torch.ops import pallas_conv3d as K6
    g = torch.Generator().manual_seed(11)
    sms = K6._sms(dev)
    for Y, X, Z, ci, co in sorted({s[1:] for s in K6_SHAPES}):
        x = torch.randn(1, Y, X, Z, ci, generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(co, ci, 3, 3, 3, generator=g)
             / (27 * ci) ** 0.5).to(dev, torch.bfloat16)
        wk = w.permute(2, 3, 4, 0, 1).reshape(27, co, ci).contiguous()
        want = K6.conv3d_3x3x3_plain(x.permute(0, 4, 1, 2, 3), w).permute(
            0, 2, 3, 4, 1).float()
        y = torch.empty(1, Y, X, Z, co, dtype=torch.bfloat16, device=dev)
        ranked = sorted(K6.plans_bf16(1, Y, X, Z, ci, co, sms))
        rows = []
        for rank, (_, p) in enumerate(ranked):
            _cuda.check(K6._launch_bf16(x, wk, y, p), "conv3d")
            torch.cuda.synchronize()
            e = ((y.float() - want).abs() / want.abs().clamp(min=1.0)).max()
            if not e.item() <= 2e-2:
                raise AssertionError(f"K6 plan {p} differs: {e.item()}")
            rows.append((graph_time(lambda: K6._launch_bf16(x, wk, y, p)),
                         rank, p))
        rows.sort()
        flops = 2.0 * Y * X * Z * 27 * ci * co
        log(f"K6 plans {Y}x{X}x{Z} {ci}->{co}: {len(rows)} plans; picked "
            f"{ranked[0][1]} {next(r[0] for r in rows if r[1] == 0):.4f} "
            f"ms, fastest {rows[0][0]:.4f} ms "
            f"({flops / rows[0][0] / 1e9:.1f} TFLOP/s)")
        for t, rank, p in rows[:6]:
            log(f"  {t:.4f} ms  model rank {rank:3d}  {p}")


def occ_levels(dev, dt, C, g):
    """The occ head's four levels at the flagship (1, C, 200/f, 200/f,
    16/f), f = 1, 2, 4, 8, and softmax blend weights (1, 4, 200, 200,
    16)."""
    import torch
    levels = [torch.randn(1, C, 200 // f, 200 // f, 16 // f,
                          generator=g).to(dev, dt) for f in (1, 2, 4, 8)]
    w = torch.softmax(torch.randn(1, 4, 200, 200, 16, generator=g),
                      1).to(dev, dt)
    return levels, w


def check_k8(dev):
    """K8 at the flagship: four 64-channel levels, bf16 (and f32), to
    (1,200,200,16) labels through 19 classes.  The lerps, blend and
    affine round at the same points in kernel and plain version; the
    class product sums exact products in f32 in another order, so a logit
    may differ by one rounding of its type: tolerance 2^-7 of max(1, max
    |logit|) in bf16, 1e-5 in f32; labels must agree on >= 99.9% of
    voxels.  The kernel is timed as the main path runs it (labels only)."""
    import torch
    from fbbev_tpu_torch.ops import pallas_occ_tail as K8
    g = torch.Generator().manual_seed(12)
    a = (torch.rand(64, generator=g) + 0.5).to(dev)
    b = (torch.randn(64, generator=g) * 0.1).to(dev)
    k2 = (torch.randn(64, 19, generator=g) / 8.0).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        levels, w = occ_levels(dev, dt, 64, g)
        with torch.no_grad():
            lab, lg = K8.occ_tail(levels, w, a, b, k2, return_logits=True)
            wlab, wlg = K8.occ_tail_plain(levels, w, a, b, k2,
                                          return_logits=True)
        torch.cuda.synchronize()
        err = (lg.float() - wlg.float()).abs().max().item()
        scale = max(1.0, wlg.float().abs().max().item())
        tol = (2.0 ** -7 if dt == torch.bfloat16 else 1e-5) * scale
        agree = (lab == wlab).float().mean().item()
        log(f"K8 {str(dt)[6:]}: logits max_abs_err {err:.3e} (tol "
            f"{tol:.1e}), labels agree on {agree:.6f}")
        if not (err <= tol and agree >= 0.999):
            raise AssertionError(f"K8 differs from its plain version: {err},"
                                 f" {agree}")
    # labels-only and logits launches give the same labels
    if not torch.equal(K8.occ_tail(levels, w, a, b, k2), lab):
        raise AssertionError("K8 labels-only launch differs from the "
                             "logits launch")
    call = (lambda: K8.occ_tail(levels, w, a, b, k2))
    ms = cuda_time(call, iters=10)
    gms = graph_time(call)
    plain_ms = cuda_time(lambda: K8.occ_tail_plain(levels, w, a, b, k2),
                         iters=3, warmup=1)
    full = 200 * 200 * 16
    nbytes = sum(lv.numel() for lv in levels) * 2 + w.numel() * 2 + full * 8
    ops = blend_ops(64) + full * 64 * 3.0      # + BN affine and relu
    log(f"K8 bf16: {ms:.4f} ms per call, {gms:.4f} ms from a graph; plan "
        f"{occ_plan_line(levels, w, True, 19)}")
    out = entry("occ_tail", "fbbev_tpu_torch/csrc/occ_tail.cu",
                "fbbev_tpu/ops/pallas_occ_tail.py:93", err, tol, ms,
                plain_ms, bound(nbytes, f32_flops=ops,
                                tc_flops=full * 64 * 19 * 2.0), None)
    out.update(graph_ms=gms)
    return out


def occ_plan_line(levels, w, tail, K=0):
    """K8's / K9's tile plan at these inputs, for the log."""
    from fbbev_tpu_torch.ops import pallas_occ_tail as K8
    B, C = levels[0].shape[:2]
    p = K8.plan_occ(B, C, *w.shape[2:], [tuple(lv.shape[2:])
                                         for lv in levels], tail,
                    levels[0].element_size(), K)
    return (f"tile {p.TY}x{p.TX}, {p.CC} channels a chunk, {p.groups} "
            f"group(s), {p.smem} B shared, grid {p.grid}")


def lib_ptxas(name):
    """The ``-Xptxas -v`` lines of the kernels of ``csrc/<name>.cu``."""
    from fbbev_tpu_torch.ops import _cuda
    with open(_cuda.build([name])[name] + ".log") as f:
        return ptxas_summary(f.read())


def blend_ops(C):
    """Operations of the upsample and blend at the flagship, C channels:
    the least a separable upsample needs -- each three-op lerp at the
    coarsest resolution it can run at (z at the level's y and x, then y,
    then x at full resolution) -- plus a multiply and an add per level."""
    full = 200 * 200 * 16
    lerps = sum(1 + 1 / f + 1 / f ** 2 for f in (2, 4, 8))
    return full * C * (3.0 * lerps + 2.0 * 4)


def check_k9(dev):
    """K9 at the flagship: four 128-channel levels blended into
    (1,128,200,200,16), bf16 (and f32).  The same rounded operations in
    the same order as the plain version: expected equal; tolerance one
    bf16 ulp of the largest output (2^-7 of it), f32 1e-6."""
    import torch
    from fbbev_tpu_torch.ops import pallas_occ_fuse as K9
    g = torch.Generator().manual_seed(13)
    for dt in (torch.float32, torch.bfloat16):
        levels, w = occ_levels(dev, dt, 128, g)
        with torch.no_grad():
            got = K9.fuse_multiscale(levels, w)
            want = K9.fuse_multiscale_plain(levels, w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = (2.0 ** -7 if dt == torch.bfloat16 else 1e-6) * \
            want.float().abs().max().item()
        log(f"K9 {str(dt)[6:]}: max_abs_err {err:.3e} (tol {tol:.1e}), "
            f"{int((got != want).sum())} of {got.numel()} elements differ")
        if not err <= tol:
            raise AssertionError(f"K9 differs from its plain version: {err}")
        del want
    call = (lambda: K9.fuse_multiscale(levels, w))
    ms = cuda_time(call, iters=10)
    gms = graph_time(call)
    plain_ms = cuda_time(lambda: K9.fuse_multiscale_plain(levels, w),
                         iters=3, warmup=1)
    full = 200 * 200 * 16
    nbytes = (sum(lv.numel() for lv in levels) + w.numel()
              + full * 128) * 2
    log(f"K9 bf16: {ms:.4f} ms per call, {gms:.4f} ms from a graph; plan "
        f"{occ_plan_line(levels, w, False)}")
    out = entry("occ_fuse", "fbbev_tpu_torch/csrc/occ_tail.cu",
                "fbbev_tpu/ops/pallas_occ_fuse.py:80", err, tol, ms,
                plain_ms, bound(nbytes, f32_flops=blend_ops(128)), None)
    out.update(graph_ms=gms)
    return out


def host_us(fn, n=200):
    """Host microseconds per call of ``fn``: ``n`` calls issued back to
    back from an idle device, without waiting for them (the launch queue
    holds them), then drained."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def wgrad_nine(x, g):
    """K7's weight gradient as nine bf16 tensor-core products per conv, one
    (Cin, Cout) product per tap of the zero-padded input's rows flattened
    (tap (dy, dx) pairs padded output row r with input row r + (dy - 1) *
    (W + 2) + dx - 1; the padded output gradient is zero off the image),
    f32 results: the alternative to the port's one product over the
    stacked windows, timed beside it."""
    import torch
    import torch.nn.functional as F
    N, Cin, H, W = x.shape
    xr, gr = (F.pad(t.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1)).reshape(
        -1, t.shape[1]) for t in (x, g))
    r0, r1 = W + 3, xr.shape[0] - (W + 3)
    taps = [torch.mm(xr[r0 + o:r1 + o].t(), gr[r0:r1],
                     out_dtype=torch.float32)
            for o in ((dy - 1) * (W + 2) + dx - 1 for dy in range(3)
                      for dx in range(3))]
    return torch.stack(taps).reshape(3, 3, Cin, -1).permute(3, 2, 0, 1)


def check_k7(dev):
    """K7 forward and input gradient at every shape of ``K7_SHAPES``, bf16
    (and f32 at three shapes), against the plain version; times of
    kernel, plain version and cuDNN (``F.conv2d`` / ``conv2d_input``), per
    call (CUDA events around back-to-back calls, the host's launch cost
    included: ``ms``, ``library_ms``) and replayed from a CUDA graph (the
    device time: ``graph_ms``, ``library_graph_ms``), each shape's line
    with the tile plan its bf16 kernel took.  Returns the forward and
    dgrad entries, their times summed over the launches of one pass.
    Tolerance: bf16 2e-2 of max(1, |value|) -- both sum in f32 and round
    once to bf16, so a sum in another order may move an output by one bf16
    ulp (2^-7 relative); f32 1e-4 absolute on O(1) outputs (f32 sums of
    9*Cin products in another order).  The entries carry the largest
    absolute bf16 error (``max_abs_err``, against 2e-2 of max(1, max
    |value|)) and the largest relative one (``max_rel_err``).
    Also, per shape: the weight gradient of the train step's backward --
    the port's one stacked bf16 tensor-core product (f32 sums) against
    the old nine f32 products (``_wgrad_f32``, the reference: within one
    bf16 rounding once cast to w's bf16, 2^-7 of |value| plus 1e-5 of the
    largest) and against nine bf16 products (``wgrad_nine``, timed only)
    -- summed over the pass's convs into the dgrad entry's
    ``wgrad_*_ms``; and the host time per call at 2x25x25 256->256, the
    wrapper's and its parts'."""
    import torch
    import torch.nn.functional as F
    from fbbev_tpu_torch.ops import pallas_conv as K7
    g = torch.Generator().manual_seed(8)
    keys = ("ms", "plain", "lib", "gms", "glib", "dms", "dplain", "dlib",
            "dgms", "dglib", "wold", "wnew", "wnine", "bytes", "flops")
    tot = {k: 0.0 for k in keys}
    err = {k: {"abs": 0.0, "tol": 0.0, "rel": 0.0}
           for k in ("fwd", "dgrad")}
    sms = K7._sms(dev)
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
            ref = K7._wgrad_f32(x, gy)
            new = K7._wgrad(x, gy)
            nine = wgrad_nine(x, gy)
            dw = (new.to(dt).float() - ref).abs()
            wtol = 2.0 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
            ds = (nine - new).abs().max().item()
            log(f"K7 wgrad N={N} {H}x{W} {ci}->{co}: bf16 product vs f32 "
                f"max_abs_err {dw.max().item():.3e}, within one bf16 "
                f"rounding: {bool((dw <= wtol).all())}; nine products vs "
                f"stacked {ds:.3e}")
            if not bool((dw <= wtol).all()):
                raise AssertionError("K7 wgrad: bf16 product differs from "
                                     "the f32 contractions")
            del ref, new, nine
            wl = w.contiguous(memory_format=cl)
            with torch.no_grad():
                t = [cuda_time(lambda: K7.conv3x3_s1(x, w), iters=10),
                     cuda_time(lambda: K7.conv3x3_s1_plain(x, w), iters=5),
                     cuda_time(lambda: F.conv2d(x, wl, padding=1), iters=10),
                     graph_time(lambda: K7.conv3x3_s1(x, w)),
                     graph_time(lambda: F.conv2d(x, wl, padding=1)),
                     cuda_time(lambda: K7._dgrad(gy, w), iters=10),
                     cuda_time(lambda: K7.conv3x3_s1_plain(gy, wt), iters=5),
                     cuda_time(lambda: torch.nn.grad.conv2d_input(
                         x.shape, w, gy, padding=1), iters=10),
                     graph_time(lambda: K7._dgrad(gy, w)),
                     graph_time(lambda: torch.nn.grad.conv2d_input(
                         x.shape, w, gy, padding=1)),
                     cuda_time(lambda: K7._wgrad_f32(x, gy).to(dt), iters=5),
                     cuda_time(lambda: K7._wgrad(x, gy).to(dt), iters=10),
                     cuda_time(lambda: wgrad_nine(x, gy).to(dt), iters=10)]
            flops = 2.0 * N * H * W * 9 * ci * co
            log(f"K7 N={N} {H}x{W} {ci}->{co} x{count}: fwd "
                f"{K7.plan_bf16(N, H, W, ci, co, sms)} kernel {t[0]:.4f} "
                f"(graph {t[3]:.4f}, {flops / t[3] / 1e9:.1f} TFLOP/s) plain "
                f"{t[1]:.4f} cuDNN {t[2]:.4f} (graph {t[4]:.4f}) ms; dgrad "
                f"{K7.plan_bf16(N, H, W, co, ci, sms)} kernel {t[5]:.4f} "
                f"(graph {t[8]:.4f}) plain {t[6]:.4f} cuDNN {t[7]:.4f} "
                f"(graph {t[9]:.4f}) ms; wgrad f32 {t[10]:.4f} bf16 stacked "
                f"{t[11]:.4f} nine {t[12]:.4f} ms")
            for k, v in zip(keys, t):
                tot[k] += count * v
            tot["bytes"] += count * (x.numel() + gy.numel() + w.numel()) * 2
            tot["flops"] += count * flops
            if (N, H, ci, co) == (2, 25, 256, 256):
                xh = x.permute(0, 2, 3, 1)
                y = torch.empty_like(xh)
                p = K7.plan_bf16(N, H, W, ci, co, sms)
                hus = [host_us(lambda: K7.conv3x3_s1(x, w)),
                       host_us(lambda: K7._dgrad(gy, w)),
                       host_us(lambda: F.conv2d(x, wl, padding=1)),
                       host_us(lambda: K7._launch_bf16(xh, w, y, p, False)),
                       host_us(lambda: torch.empty_like(xh))]
                log(f"K7 host time per call at N={N} {H}x{W} {ci}->{co} "
                    f"({p}): fwd {hus[0]:.1f} us, dgrad {hus[1]:.1f} us "
                    f"(wrapper included); F.conv2d {hus[2]:.1f} us.  Parts "
                    f"of the forward: the launch through ctypes (plan "
                    f"given; workspace allocated, weight relayout, tensor "
                    f"maps, conv, split-K sum) {hus[3]:.1f} us, one "
                    f"torch.empty {hus[4]:.1f} us")
    b = bound(tot["bytes"], tc_flops=tot["flops"])
    n = sum(c for _, c in K7_SHAPES)
    log(f"K7 over the {n} launches of one pass: fwd {tot['ms']:.4f} ms per "
        f"call, {tot['gms']:.4f} ms from a graph (cuDNN {tot['lib']:.4f} / "
        f"{tot['glib']:.4f}); dgrad {tot['dms']:.4f} / {tot['dgms']:.4f} ms "
        f"(cuDNN {tot['dlib']:.4f} / {tot['dglib']:.4f}); bound {b[0]:.4f} "
        f"ms each ({b[1]}); wgrad per step: f32 {tot['wold']:.4f} ms, bf16 "
        f"one stacked product {tot['wnew']:.4f} ms, nine products "
        f"{tot['wnine']:.4f} ms")
    src = "fbbev_tpu_torch/csrc/conv3x3.cu"
    out = []
    for name, kind, line, pre in (("conv3x3", "fwd", 67, ""),
                                  ("conv3x3_dgrad", "dgrad", 145, "d")):
        e = err[kind]
        out.append(entry(name, src, f"fbbev_tpu/ops/pallas_conv.py:{line}",
                         e["abs"], e["tol"], tot[pre + "ms"],
                         tot[pre + "plain"], b, tot[pre + "lib"]))
        out[-1].update(max_rel_err=e["rel"], graph_ms=tot[pre + "gms"],
                       library_graph_ms=tot[pre + "glib"])
    out[1].update(wgrad_f32_ms=tot["wold"], wgrad_bf16_ms=tot["wnew"],
                  wgrad_nine_ms=tot["wnine"])
    return out


def k7_plans(dev):
    """``--k7-plans``: at each distinct K7 shape, forward and input
    gradient, every legal tile plan of the bf16 kernel
    (``pallas_conv.plans_bf16``) checked against the plain version (2e-2
    of max(1, |y|)) and timed from a CUDA graph, all listed fastest first
    with the model's rank (the data ``plan_bf16``'s step times were fitted
    to), and the plan it picks."""
    import torch
    from fbbev_tpu_torch.ops import _cuda
    from fbbev_tpu_torch.ops import pallas_conv as K7
    g = torch.Generator().manual_seed(8)
    sms = K7._sms(dev)
    total = {"picked": 0.0, "fastest": 0.0}
    sweep = []  # (count, N, H, W, Cin, Cout, {plan: seconds})
    for (N, H, W, ci, co), count in K7_SHAPES:
        w = (torch.randn(co, ci, 3, 3, generator=g) * 0.5
             / (9 * ci) ** 0.5).to(dev, torch.bfloat16)
        for dgrad, a, b in ((False, ci, co), (True, co, ci)):
            xh = torch.randn(N, H, W, a, generator=g).to(dev, torch.bfloat16)
            conv_w = w.flip(2, 3).transpose(0, 1) if dgrad else w
            want = K7.conv3x3_s1_plain(xh.permute(0, 3, 1, 2),
                                       conv_w).permute(0, 2, 3, 1).float()
            y = torch.empty(N, H, W, b, dtype=torch.bfloat16, device=dev)
            ranked = sorted(K7.plans_bf16(N, H, W, a, b, sms))
            rows = []
            for rank, (_, p) in enumerate(ranked):
                _cuda.check(K7._launch_bf16(xh, w, y, p, dgrad), "conv3x3")
                torch.cuda.synchronize()
                e = ((y.float() - want).abs() / want.abs().clamp(min=1.0)
                     ).max().item()
                if not e <= 2e-2:
                    raise AssertionError(f"K7 plan {p} differs: {e}")
                rows.append((graph_time(lambda: K7._launch_bf16(
                    xh, w, y, p, dgrad)), rank, p))
            rows.sort()
            picked = next(r[0] for r in rows if r[1] == 0)
            total["picked"] += count * picked
            total["fastest"] += count * rows[0][0]
            flops = 2.0 * N * H * W * 9 * a * b
            log(f"K7 plans {'dgrad' if dgrad else 'fwd'} N={N} {H}x{W} "
                f"{a}->{b} x{count}: {len(rows)} plans; picked {ranked[0][1]}"
                f" {picked:.4f} ms, fastest {rows[0][0]:.4f} ms "
                f"({flops / rows[0][0] / 1e9:.1f} TFLOP/s)")
            for t, rank, p in rows:
                log(f"  {t:.4f} ms  model rank {rank:3d}  {p}")
            sweep.append((count, N, H, W, a, b,
                          {p: 1e-3 * t for t, _, p in rows}))
    log(f"K7 plans over one pass, forward + dgrad: picked "
        f"{total['picked']:.4f} ms, fastest {total['fastest']:.4f} ms "
        f"(graph times)")
    fit_k7_model(sweep, sms)


def fit_k7_model(sweep, sms):
    """Least-squares fit of ``pallas_conv.modelled_time``'s constants --
    the step time of each (BM, BN) tile, the wave and split times -- to
    every plan's time in ``sweep`` (rows weighted by 1 / time, so relative
    errors count), printed as code; then the pass as the fitted model would
    pick it, timed by the sweep (in-sample)."""
    from fbbev_tpu_torch.ops import pallas_conv as K7
    from fbbev_tpu_torch.ops import pallas_conv3d as K6
    tiles = sorted(K7.STEP_S)
    rows, rhs = [], []
    for _, N, H, W, a, b, times in sweep:
        steps, out = K7.k_steps(a), N * H * W * b
        for p, t in times.items():
            slots = min(2, K6.SMEM_PER_SM // K6.smem_bytes(p.BM, p.BN))
            waves = -(-N * p.tiles_y * p.tiles_x * p.tiles_n * p.S
                      // (sms * slots))
            r = [0.0] * (len(tiles) + 2)
            r[tiles.index((p.BM, p.BN))] = waves * (steps // p.S)
            r[-2] = waves
            r[-1] = float(p.S > 1)
            split_bytes = (8 * p.S + 2) * out / K6.HBM_BPS if p.S > 1 else 0
            rows.append([v / t for v in r])
            rhs.append((t - split_bytes) / t)
    coef = np.linalg.lstsq(np.array(rows), np.array(rhs), rcond=None)[0]
    step_s = {tile: float(c) for tile, c in zip(tiles, coef)}
    wave_s, split_s = float(coef[-2]), float(coef[-1])
    rel = np.abs(np.array(rows) @ coef - np.array(rhs))
    log(f"K7 plan model fitted to {len(rhs)} plan times (relative error "
        f"median {np.median(rel):.3f}, max {rel.max():.3f}):")
    log("  STEP_S = {" + ", ".join(f"{t}: {v:.4e}" for t, v in
                                   step_s.items()) + "}")
    log(f"  WAVE_S = {wave_s:.4e}")
    log(f"  SPLIT_S = {split_s:.4e}")
    picked = 0.0
    for count, N, H, W, a, b, times in sweep:
        best = min((round(K7.modelled_time(
            N * p.tiles_y * p.tiles_x * p.tiles_n, K7.k_steps(a), p.BM, p.BN,
            p.S, N * H * W * b, sms, step_s, wave_s, split_s) * 1e8),
            p.tiles_y * p.TY * p.tiles_x * p.TX, -p.BM, p.S, p)
            for p in times)[-1]
        picked += count * 1e3 * times[best]
    log(f"K7 plans over one pass, forward + dgrad, as the fitted model "
        f"picks them: {picked:.4f} ms (graph times, in-sample)")


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
    from fbbev_tpu_torch.ops import pallas_conv
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
    reset_counts()
    pallas_conv.launches = pallas_conv.dgrad_launches = 0
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
                  conv3x3_dgrad=pallas_conv.dgrad_launches, **read_counts())
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
    if any(read_counts().values()):
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


# the port's route arguments of the kernel-routed configurations, and the
# launches of each kernel per frame of their streams (any other, K10's
# pallas_deform among them: none)
ROUTED = dict(fuse_warp=False, pallas_conv3d=True, occ_tail=True)
BLEND = dict(coarse_pred=False, occ_fuse=True)
PER_FRAME = {
    "default": dict(bev_pool=1, msda=1, msda_selfattn=1, fuse_warp=1),
    "routed": dict(bev_pool=1, msda=1, msda_selfattn=1, warp_affine=1,
                   conv3d=16, occ_tail=1),
    "blend": dict(bev_pool=1, msda=1, msda_selfattn=1, fuse_warp=1,
                  occ_fuse=1),
    # the float32 tiny config: K1's f32 epilogue kernel
    "f32": dict(bev_pool=1, msda=1, msda_selfattn=1, fuse_warp_f32=1),
    # FBOCC.forward in eval (tools.benchmark's inference): the segment-sum
    # voxel pool, K3 twice, K1; in training none of them
    "forward": dict(msda=1, msda_selfattn=1, fuse_warp=1),
    "train": dict(),
}


def _counted():
    """(module, counter attribute, name) of every serving kernel."""
    from fbbev_tpu_torch.ops import pallas_conv3d, pallas_deform, \
        pallas_fuse_warp, pallas_occ_fuse, pallas_occ_tail, pallas_pool, \
        pallas_sample, pallas_warp
    return [(pallas_pool, "launches", "bev_pool"),
            (pallas_sample, "launches", "msda"),
            (pallas_sample, "selfattn_launches", "msda_selfattn"),
            (pallas_fuse_warp, "launches", "fuse_warp"),
            (pallas_fuse_warp, "f32_launches", "fuse_warp_f32"),
            (pallas_warp, "launches", "warp_affine"),
            (pallas_conv3d, "launches", "conv3d"),
            (pallas_occ_tail, "launches", "occ_tail"),
            (pallas_occ_fuse, "launches", "occ_fuse"),
            (pallas_deform, "launches", "pallas_deform")]


def reset_counts():
    for mod, attr, _ in _counted():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr) for mod, attr, name in _counted()}


def run_stream(dev, label, frames, **routes):
    """A full-width bf16 flagship stream of ``frames`` frames (a sequence
    start, then flow(1)) with the model's route arguments ``routes``:
    labels (1,200,200,16), finite logits, and exactly PER_FRAME[label]
    launches of each kernel per frame.  Returns (counts, median ms of
    frames 2..)."""
    import torch
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.models.layers import Conv3dK6
    from fbbev_tpu_torch.ops import pallas_occ_tail
    from fbbev_tpu_torch.serving import FixedRigPipeline
    t0 = time.perf_counter()
    model = FBOCC(dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0), **routes)
    pipe = FixedRigPipeline(model, flagship_rig())
    log(f"{label} stream {routes}: model + rig-static terms built in "
        f"{time.perf_counter() - t0:.1f} s")
    logits, tail_args, cl3d = [], [], []
    model.occupancy_head.occ_pred_conv[3].register_forward_hook(
        lambda m, i, o: logits.append(bool(torch.isfinite(o).all()))
        or None)
    for m in model.modules():
        if isinstance(m, Conv3dK6):
            m.register_forward_pre_hook(lambda m, i: cl3d.append(
                i[0].is_contiguous(memory_format=torch.channels_last_3d))
                or None)
    real_tail = pallas_occ_tail.occ_tail

    def tail(*a, **k):  # keeps the last frame's K8 inputs for the check
        tail_args[:] = [a]
        return real_tail(*a, **k)

    pallas_occ_tail.occ_tail = tail
    g = torch.Generator().manual_seed(1)
    imgs = [torch.randn(1, 6, 256, 704, 3, generator=g).to(dev)
            for _ in range(frames)]
    try:
        reset_counts()
        times = []
        for i in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = pipe(imgs[i], i == 0, flow(0 if i == 0 else 1))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        counts = read_counts()
    finally:
        pallas_occ_tail.occ_tail = real_tail
    log(f"{label} frames: {frames}, ms per frame "
        f"{[round(x, 2) for x in times]}, median "
        f"{float(np.median(times[1:])):.2f} ms (frames 2..{frames})")
    log(f"launches in the {label} stream: {counts}")
    if tuple(labels.shape) != (1, 200, 200, 16):
        raise AssertionError(f"labels shape {tuple(labels.shape)}")
    if tail_args:
        # the tail's logits, which the stream never materialises: from the
        # last frame's K8 inputs, after the counts were read
        with torch.no_grad():
            lab, lg = real_tail(*tail_args[0], return_logits=True)
        logits = [bool(torch.isfinite(lg).all())] * frames
        if not torch.equal(lab, labels):
            raise AssertionError("K8 labels differ between two launches")
    if not (len(logits) == frames and all(logits)):
        raise AssertionError(f"non-finite logits: {logits}")
    if cl3d:
        log(f"K6 module inputs in channels_last_3d memory: {sum(cl3d)} of "
            f"{len(cl3d)}")
    lab = labels.flatten().bincount(minlength=19).tolist()
    log(f"labels of the last frame by class: {lab}")
    want = {k: PER_FRAME[label].get(k, 0) * frames for k in counts}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    del pipe, model
    torch.cuda.empty_cache()
    return counts, float(np.median(times[1:]))


def run_small_parity(dev, **routes):
    """A small bf16 config with the route arguments ``routes`` on the card
    (kernels, cuDNN) vs the same model on the CPU (plain versions,
    oneDNN): labels must agree on >= 95% of voxels (bf16 convolutions
    round differently in the two libraries, and random-weight logits have
    near-ties)."""
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
                  generator=torch.Generator().manual_seed(5), **routes)
        pipe = FixedRigPipeline(m, rig)
        g = torch.Generator().manual_seed(6)
        out[d] = [pipe(torch.randn(1, 2, 64, 128, 3, generator=g), i == 0,
                       flow(i)).cpu() for i in range(3)]
    agree = min(float((a == b).float().mean())
                for a, b in zip(out["cpu"], out[dev]))
    log(f"small bf16 config {routes}, card vs CPU plain versions: label "
        f"agreement {agree:.5f} (min over 3 frames)")
    if agree < 0.95:
        raise AssertionError(f"card and CPU disagree: {agree}")


CONFIGS = os.path.join(ROOT, "fbbev_tpu_torch", "configs")


def config_stream(pipe, imgs, label, hooks=()):
    """``imgs`` through ``pipe`` (a sequence start, then flow(1)) with the
    launch counts set to 0 just before and read just after; checks
    finite logits on every frame.  Returns (labels per frame on the CPU,
    counts)."""
    import torch
    model = pipe.model
    finite = []
    handle = model.occupancy_head.occ_pred_conv[3].register_forward_hook(
        lambda m, i, o: finite.append(bool(torch.isfinite(o).all())) or None)
    try:
        reset_counts()
        labels = [pipe(im, i == 0, flow(0 if i == 0 else 1)).cpu()
                  for i, im in enumerate(imgs)]
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        handle.remove()
    if not (len(finite) == len(imgs) and all(finite)):
        raise AssertionError(f"{label}: non-finite logits {finite}")
    log(f"launches in the {label} stream: {counts}")
    return labels, counts


def expect_counts(label, counts, frames, per_frame):
    want = {k: per_frame.get(k, 0) * frames for k in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def run_config(dev):
    """The config-built serving entry: models built from the port's config
    files through ``train.loop.build_model``, BatchNorms folded.

    1. The flagship (``fbocc-r50-cbgs_depth_16f.py``) in float32 with a
       seeded generator, its BatchNorm statistics and scales perturbed,
       folded (a copy unfolded), both cast to the config's bf16: a 5-frame
       stream through each, label agreement >= 0.98, finite logits, and
       per frame exactly K1 1, K2 1, K3 2 (cross- and self-attention).
    2. ``FixedRigPipeline.benchmark(iters=20)`` on the folded flagship.
    3. The single-frame config (``fbocc-r50_depth_1f.py``, K1 at T = 1):
       3 frames, K1's last launch held against its plain version on the
       same inputs, and K1 at T = 1 checked and timed alone.
    4. The tiny config (``fbocc-r50-tiny_synthetic.py``: 2 cameras at
       64x176, a 25x25x8 grid, T = 2) on the card and on the CPU in its
       own float32: labels agree on >= 95% of voxels, K1's f32 kernel
       launched once a frame and held against its plain version.
    5. Both tools' ``main`` on the flagship at few iterations, each with
       its exact launch counts.

    Returns K1 at T = 1 (``check_k1``'s entry) and K1's f32 kernel
    (``check_k1_f32``'s)."""
    import copy
    import torch
    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.ops import pallas_fuse_warp as K1
    from fbbev_tpu_torch.serving import FixedRigPipeline
    from fbbev_tpu_torch.tools import benchmark, serving_bench
    from fbbev_tpu_torch.train.loop import build_model
    from fbbev_tpu_torch.utils.fuse_bn import build_folded, \
        fold_batch_norms, perturb_batch_norms
    bf16 = torch.bfloat16
    flagship = os.path.join(CONFIGS, "fbocc-r50-cbgs_depth_16f.py")
    cfg = Config.fromfile(flagship)
    t0 = time.perf_counter()
    unfolded = build_model(cfg, device=dev, dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0))
    perturb_batch_norms(unfolded, torch.Generator().manual_seed(3))
    folded = copy.deepcopy(unfolded)
    pairs = fold_batch_norms(folded)
    unfolded.cast(bf16)
    folded.cast(bf16)
    log(f"config: flagship built from {os.path.relpath(flagship, ROOT)}, "
        f"BatchNorms perturbed, {len(pairs)} conv/BN pairs folded, cast to "
        f"bf16 in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(1)
    imgs = [torch.randn(1, 6, 256, 704, 3, generator=g).to(dev)
            for _ in range(5)]
    labels = {}
    for label, model in (("folded", folded), ("unfolded", unfolded)):
        pipe = FixedRigPipeline(model, flagship_rig())
        labels[label], counts = config_stream(pipe, imgs,
                                              f"config {label} flagship")
        expect_counts(label, counts, 5, PER_FRAME["default"])
        if label == "folded":
            folded_pipe = pipe
    agree = [float((a == b).float().mean())
             for a, b in zip(labels["folded"], labels["unfolded"])]
    log(f"config: folded vs unfolded bf16 flagship label agreement per "
        f"frame {[round(a, 5) for a in agree]}, min {min(agree):.5f}")
    if min(agree) < 0.98:
        raise AssertionError(f"folded and unfolded disagree: {agree}")
    del unfolded
    torch.cuda.empty_cache()

    fps = folded_pipe.benchmark(iters=20)
    log(f"config: FixedRigPipeline.benchmark(iters=20), folded bf16 "
        f"flagship: {fps:.4f} frames/s, {1e3 / fps:.4f} ms per frame "
        f"({nvidia_smi_line()})")
    del folded_pipe, folded, pipe, model
    torch.cuda.empty_cache()

    # the single-frame config: K1 at T = 1 on the stream's own inputs
    cfg1 = Config.fromfile(os.path.join(CONFIGS, "fbocc-r50_depth_1f.py"))
    model = build_folded(cfg1, device=dev,
                         generator=torch.Generator().manual_seed(0))
    pipe = FixedRigPipeline(model, flagship_rig())
    (_, counts), (a, k) = k1_captured(lambda: config_stream(
        pipe, imgs[:3], "config single-frame"))
    expect_counts("single-frame", counts, 3, PER_FRAME["default"])
    if a[0].shape[-1] != 80:
        raise AssertionError(f"single-frame history {tuple(a[0].shape)}")
    got, gh = K1.fuse_warp(*a, **k)
    want, wh = K1.fuse_warp_plain(*a, **k)
    err = (got.float() - want.float()).abs().max().item()
    herr = (gh.float() - wh.float()).abs().max().item()
    log(f"config: single-frame stream, K1 at T=1 against its plain version "
        f"on the last frame's inputs: fused max_abs_err {err:.3e} (tol "
        f"2e-2), new history {herr:.3e} (tol one bf16 ulp of "
        f"{wh.float().abs().max().item():.3e})")
    if err > 2e-2 or herr > 2.0 ** -7 * wh.float().abs().max().item():
        raise AssertionError("K1 at T=1 differs from its plain version")
    del pipe, model, a, k
    torch.cuda.empty_cache()
    k1_t1 = check_k1(dev, epilogue=True, T=1)

    # the tiny config in its own float32 on the card and on the CPU; K1's
    # f32 kernel held against its plain version on the stream's inputs
    tiny = Config.fromfile(os.path.join(CONFIGS,
                                        "fbocc-r50-tiny_synthetic.py"))
    out = {}
    for d in ("cpu", dev):
        m = build_model(tiny, device=d,
                        generator=torch.Generator().manual_seed(5))
        if m.dtype != torch.float32:
            raise AssertionError(f"tiny config built in {m.dtype}")
        pipe = FixedRigPipeline(m, flagship_rig(N=2, H=64, W=176))
        g = torch.Generator().manual_seed(6)
        frames = [torch.randn(1, 2, 64, 176, 3, generator=g)
                  for _ in range(3)]
        if d == "cpu":
            out[d] = [pipe(f, i == 0, flow(0 if i == 0 else 1))
                      for i, f in enumerate(frames)]
        else:
            (out[d], counts), (a, k) = k1_captured(lambda: config_stream(
                pipe, frames, "config tiny (float32)"))
            expect_counts("tiny", counts, 3, PER_FRAME["f32"])
    agree = min(float((x == y).float().mean())
                for x, y in zip(out["cpu"], out[dev]))
    log(f"config: tiny config (float32), card vs CPU plain versions: label "
        f"agreement {agree:.5f} (min over 3 frames)")
    if agree < 0.95:
        raise AssertionError(f"tiny config: card and CPU disagree: {agree}")
    k1_f32 = check_k1_f32(a, k, counts["fuse_warp_f32"])
    del pipe, m, a, k

    # the tools on the flagship, each run with the counts set to 0 just
    # before it: serving_bench's (rounds + 1) x chunk frames, benchmark's
    # iters + 1 eval forwards (K1 1, K3 2 each) or train steps (none)
    for tool, argv, calls, per in (
            (serving_bench, [flagship, "--chunk", "4", "--rounds", "2"], 12,
             "default"),
            (benchmark, [flagship, "--iters", "5"], 6, "forward"),
            (benchmark, [flagship, "--iters", "3", "--train-step"], 4,
             "train")):
        t0 = time.perf_counter()
        reset_counts()
        line = tool.main(argv)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"config: {tool.__name__.rsplit('.', 1)[-1]} {argv[1:]} took "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(line)} "
            f"({nvidia_smi_line()}); launches {counts}")
        expect_counts(f"{tool.__name__} {argv[1:]}", counts, calls,
                      PER_FRAME[per])
        torch.cuda.empty_cache()
    return k1_t1, k1_f32


SMOKE = "fbocc-r50_synthetic_smoke.py"
LOOP_ITERS = (6, 12)  # the first train run, then resumed to
EVAL_SAMPLES = 4


def _states_equal(a, b):
    """Two TrainStates bit for bit: every tensor, the step and counts."""
    import torch
    from fbbev_tpu_torch.train.checkpoints import state_to_dict
    da, db = state_to_dict(a), state_to_dict(b)
    flat = []
    for d in (da, db):
        opt = d.pop("opt_state")
        d.update({f"opt_state.{k}": v for k, v in opt.items()})
        flat.append(d)
    da, db = flat
    if set(da) != set(db):
        return False
    return all(torch.equal(da[k], db[k]) if isinstance(da[k], torch.Tensor)
               else da[k] == db[k] for k in da)


def run_loop(dev):
    """The training and evaluation loop (``train.loop``) and its tools on
    the flagship: ``fbocc-r50_synthetic_smoke.py`` -- 6 cameras at
    256x704, a 100x100x8 BEV of 80 channels with 16 history frames,
    200x200x16 x 19 classes, batch 1, bf16, ResNet stages checkpointed --
    with K7 (``pallas3x3=True``), its work dir in a temporary directory
    deleted at the end, pass or fail.

    1. ``train(max_iters=6)`` (the curriculum flips at 3), then
       ``train(max_iters=12, resume=True)``: finite losses, the step at
       12, the step-6 checkpoint restored equal bit for bit to the first
       run's final state, every step exactly K7_STEP launches of K7
       (forward, dgrad) and none of the others.
    2. ``evaluate(max_samples=4)`` from the latest checkpoint on the EMA
       weights: n_samples 4, a finite mIoU, exactly K1 4, K3 4 + 4
       (cross- and self-attention), K2 0 and none of the others.
    3. ``tools.train --max-iters 2`` and ``tools.test --max-samples 1``
       through their ``main(argv)``, each with its exact launch counts.
    4. Prints the loop's ms per iteration, peak device memory, each
       checkpoint's bytes and save / restore seconds and the eval seconds
       per sample, beside the card's name and power limit.

    Returns the launch counts of the train runs and of the evaluation."""
    import tempfile
    import torch
    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.data import collate
    from fbbev_tpu_torch.ops import pallas_conv as K7
    from fbbev_tpu_torch.tools import test as test_tool
    from fbbev_tpu_torch.tools import train as train_tool
    from fbbev_tpu_torch.train import checkpoints as CK
    from fbbev_tpu_torch.train import loop
    from fbbev_tpu_torch.train.trainer import Trainer
    t_phase = time.perf_counter()
    smoke = os.path.join(CONFIGS, SMOKE)
    cfg = Config.fromfile(smoke)
    card = nvidia_smi_line()
    per_pass = sum(c for _, c in K7_SHAPES)
    k7_step = dict(conv3x3=per_pass + K7_RESNET_LAUNCHES,
                   conv3x3_dgrad=per_pass)

    def counts():
        return dict(conv3x3=K7.launches, conv3x3_dgrad=K7.dgrad_launches,
                    **read_counts())

    def reset():
        reset_counts()
        K7.launches = K7.dgrad_launches = 0

    def expect(label, got, want):
        want = {k: want.get(k, 0) for k in got}
        if got != want:
            raise AssertionError(f"loop {label}: launches {got}, expected "
                                 f"{want}")

    steps, spans, saves, restores, passes = [], [], [], [], []
    real = (Trainer.train_step, loop.save_checkpoint,
            loop.restore_checkpoint, loop._eval_pass)

    def train_step(self, *a, **k):
        # launch counts and the step's span on the stream (CUDA events:
        # no sync, the loop's overlap of host and device is kept)
        before = counts()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        out = real[0](self, *a, **k)
        e[1].record()
        spans.append(e)
        steps.append({n: v - before[n] for n, v in counts().items()})
        return out

    def save(ckpt_dir, state, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = real[1](ckpt_dir, state, *a, **k)
        saves.append((int(state.step), os.path.getsize(path),
                      time.perf_counter() - t))
        return path

    def restore(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real[2](*a, **k)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t)
        return out

    def eval_pass(*a):
        t = time.perf_counter()
        n = real[3](*a)  # ends with the last logits on the host
        passes.append((n, time.perf_counter() - t))
        return n

    Trainer.train_step = train_step
    loop.save_checkpoint, loop.restore_checkpoint = save, restore
    loop._eval_pass = eval_pass
    try:
        with tempfile.TemporaryDirectory(prefix="fbbev_loop_") as work:
            ckpts = os.path.join(work, "ckpts")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            t0 = time.perf_counter()
            first = loop.train(cfg, max_iters=LOOP_ITERS[0], work_dir=work,
                               device=dev, pallas3x3=True)
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            if not _states_equal(CK.restore_checkpoint(
                    ckpts, first["state"], step=LOOP_ITERS[0]),
                    first["state"]):
                raise AssertionError("the restored step-6 checkpoint "
                                     "differs from the run's final state")
            step6 = int(first["state"].step)
            hist = first["history"]
            del first
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            second = loop.train(cfg, max_iters=LOOP_ITERS[1], work_dir=work,
                                device=dev, resume=True, pallas3x3=True)
            torch.cuda.synchronize()
            t_second = time.perf_counter() - t0
            train_counts = counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            hist += second["history"]
            if int(second["state"].step) != LOOP_ITERS[1]:
                raise AssertionError(f"resumed to step "
                                     f"{second['state'].step}")
            del second
            torch.cuda.empty_cache()
            log(f"loop: train to {LOOP_ITERS[0]} in {t_first:.1f} s, resumed "
                f"to {LOOP_ITERS[1]} in {t_second:.1f} s (model builds "
                f"included); launches {train_counts}")
            if len(steps) != LOOP_ITERS[1]:
                raise AssertionError(f"{len(steps)} train steps ran")
            for i, c in enumerate(steps):
                expect(f"train step {i + 1}", c, k7_step)
            for h in hist:
                bad = {k: v for k, v in h.items() if not np.isfinite(v)}
                if bad:
                    raise AssertionError(f"non-finite loop metrics {bad}")
            span = [a.elapsed_time(b) for a, b in spans]
            t0 = time.perf_counter()
            sample = collate([loop.build_dataset(cfg)[0]])
            t_make = time.perf_counter() - t0
            t0 = time.perf_counter()
            loop._put_batch(sample, dev)
            torch.cuda.synchronize()
            t_copy = time.perf_counter() - t0
            log(f"loop: time_per_iter (the loop's: mean from its run's "
                f"start, at each log) "
                f"{[(h['iter'], round(h['time_per_iter'] * 1e3, 1)) for h in hist]}"
                f" ms; train_step span on the stream (CUDA events) median "
                f"{np.median(span[LOOP_ITERS[0] + 1:]):.1f} ms over steps "
                f"{LOOP_ITERS[0] + 2}..{LOOP_ITERS[1]}, first of each run "
                f"{span[0]:.1f} / {span[LOOP_ITERS[0]]:.1f} ms; a batch "
                f"made and collated {t_make * 1e3:.1f} ms, copied to the "
                f"card {t_copy * 1e3:.1f} ms (host clock); peak device "
                f"memory {peak:.2f} GiB ({card})")
            log(f"loop: checkpoints (step, bytes, save s): "
                f"{[(st, b, round(t, 3)) for st, b, t in saves]}; restores "
                f"{[round(t, 3) for t in restores]} s ({card})")
            if step6 != LOOP_ITERS[0]:
                raise AssertionError(f"the first run ended at step {step6}")

            reset()
            t0 = time.perf_counter()
            res = loop.evaluate(cfg, work_dir=work, max_samples=EVAL_SAMPLES,
                                device=dev)
            torch.cuda.synchronize()
            eval_counts = counts()
            n, secs = passes[-1]
            log(f"loop: evaluate {json.dumps(res)} in "
                f"{time.perf_counter() - t0:.1f} s (model build and restore "
                f"included); launches {eval_counts}")
            log(f"loop: eval {secs / n * 1e3:.1f} ms a sample (host clock, "
                f"the pass over {n} samples: data, eval_step, logits to the "
                f"host, format and metric) ({card})")
            if res["n_samples"] != EVAL_SAMPLES or not np.isfinite(
                    res["Overall"]):
                raise AssertionError(f"evaluate returned {res}")
            expect("evaluate", eval_counts,
                   {k: EVAL_SAMPLES * v
                    for k, v in PER_FRAME["forward"].items()})

            tools = os.path.join(work, "tools")
            for tool, argv, want in (
                    (train_tool, ["--max-iters", "2"], {}),
                    (test_tool, ["--max-samples", "1"],
                     PER_FRAME["forward"])):
                reset()
                t0 = time.perf_counter()
                out = tool.main([smoke, "--work-dir", tools] + argv)
                torch.cuda.synchronize()
                c = counts()
                log(f"loop: {tool.__name__} {' '.join(argv)} in "
                    f"{time.perf_counter() - t0:.1f} s; launches {c}")
                expect(tool.__name__, c, want)
                if tool is train_tool and int(out["state"].step) != 2:
                    raise AssertionError("tools.train did not take 2 steps")
                if tool is test_tool and out["n_samples"] != 1:
                    raise AssertionError(f"tools.test returned {out}")
                del out
                torch.cuda.empty_cache()
    finally:
        Trainer.train_step = real[0]
        loop.save_checkpoint, loop.restore_checkpoint = real[1], real[2]
        loop._eval_pass = real[3]
    log(f"loop phase: {time.perf_counter() - t_phase:.1f} s")
    return train_counts, eval_counts


def k1_captured(run):
    """``run()`` with K1's wrapper recording its inputs: (run's result,
    (args, kwargs) of K1's last call)."""
    from fbbev_tpu_torch.ops import pallas_fuse_warp as K1
    real, seen = K1.fuse_warp, []

    def fuse_warp(*a, **k):
        seen[:] = [(a, k)]
        return real(*a, **k)

    K1.fuse_warp = fuse_warp
    try:
        result = run()
    finally:
        K1.fuse_warp = real
    return result, seen[0]


def check_k1_f32(a, k, launches):
    """K1's f32 epilogue kernel against its plain version on the tiny
    config's last K1 inputs (f32 history (1, 8, 25, 25, 2*80), F = 160):
    the new history (the same f32 operations in the same order: expected
    bit-identical) and the fused part (f32 sums in another order), timed
    per call and from a CUDA graph; its bound on the FP32 cores."""
    import torch
    from fbbev_tpu_torch.ops import pallas_fuse_warp as K1
    hist, curr = a[0], a[1]
    epi = k["epilogue"]
    if hist.dtype != torch.float32:
        raise AssertionError(f"tiny K1 history {hist.dtype}")
    got, gh = K1.fuse_warp(*a, **k)
    want, wh = K1.fuse_warp_plain(*a, **k)
    torch.cuda.synchronize()
    herr = (gh - wh).abs().max().item()
    log(f"K1 f32 new history: max |diff| {herr:.3e}")
    if herr > 1e-6 * wh.abs().max().item():
        raise AssertionError("K1 f32 new history differs from its plain "
                             "version")
    err = (got - want).abs().max().item()
    call = (lambda: K1.fuse_warp(*a, **k))
    ms = cuda_time(call, iters=10)
    gms = graph_time(call)
    plain_ms = cuda_time(lambda: K1.fuse_warp_plain(*a, **k), iters=3,
                         warmup=1)
    log(f"K1 f32 at {tuple(hist.shape)}: {ms:.4f} ms per call, {gms:.4f} "
        f"ms from a graph")
    B, Z, Y, X, TC = hist.shape
    C, F = curr.shape[-1], epi["ws"].shape[-1]
    T, V = TC // C, B * Z * Y * X
    nbytes = 4 * (2 * hist.numel() + curr.numel() + got.numel()
                  + epi["ws"].numel() + C * C)
    flops = 2.0 * 8 * V * T * C + 2.0 * V * T * C * (C + F)
    out = entry("fuse_warp_f32", "fbbev_tpu_torch/csrc/fuse_warp.cu",
                "fbbev_tpu/ops/pallas_fuse_warp.py:280", err,
                1e-4 * max(1.0, want.abs().max().item()), ms, plain_ms,
                bound(nbytes, f32_flops=flops), None)
    out.update(launches=launches, graph_ms=gms)
    return out


def profile_frames(pipe, imgs, frames, ours, label):
    """Steady frame time of ``pipe`` (CUDA events, mean of 20), then
    ``torch.profiler`` over ``frames`` frames: kernel time and device idle
    share, device time by stage, the top kernels (the port's tagged)."""
    import torch
    from torch.profiler import ProfilerActivity
    ms = cuda_time(lambda: pipe(imgs[1], False, flow(1)), iters=20)
    log(f"{label}: flagship steady frame {ms:.3f} ms (CUDA events, mean "
        f"of 20)")
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
    for o in ours:
        mine = [e for e in kern if o in e.key]
        if mine:
            log(f"  port kernels {o:16s} {sum(dt(e) for e in mine):8.3f} ms "
                f"x{sum(e.count for e in mine) // frames} per frame")
    for e in sorted(kern, key=dt, reverse=True)[:16]:
        tag = "port" if any(o in e.key for o in ours) else "    "
        log(f"  {tag} kernel {dt(e):8.3f} ms x{e.count // frames:<3d} "
            f"{e.key[:80]}")


# name fragments of the port's own kernels in a profile
PORT_KERNELS = ("bev_pool_kernel", "msda_kernel", "fuse_warp_kernel",
                "fuse_warp_epi", "warp_box_kernel", "conv3d_", "split_sum",
                "occ_")


def profile_images(dev):
    """Three flagship 6-camera frames of seeded noise on the card."""
    import torch
    g = torch.Generator().manual_seed(1)
    return [torch.randn(1, 6, 256, 704, 3, generator=g).to(dev)
            for _ in range(3)]


def profile_default(dev, frames=5):
    """``--profile-default``: the default configuration alone, as
    :func:`profile` times and profiles it (cuDNN's autotuner off)."""
    import torch
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.serving import FixedRigPipeline
    imgs = profile_images(dev)
    model = FBOCC(dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))
    pipe = FixedRigPipeline(model, flagship_rig())
    pipe(imgs[0], True)
    profile_frames(pipe, imgs, frames, PORT_KERNELS,
                   "default {} cudnn.benchmark=False")


def profile_occ(dev, frames=5):
    """``--profile-occ``: the two streams that take K8 and K9 -- routed
    (``ROUTED``, K8) and blend (``BLEND``, K9) -- timed and profiled as
    :func:`profile` does.  It profiles whatever package sits beside this
    script, so a copy of it beside an older tree's package compares the
    two on one card."""
    import torch
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.serving import FixedRigPipeline
    imgs = profile_images(dev)
    for label, routes in (("routed", ROUTED), ("blend", BLEND)):
        model = FBOCC(dtype=torch.bfloat16, device=dev,
                      generator=torch.Generator().manual_seed(0), **routes)
        pipe = FixedRigPipeline(model, flagship_rig())
        pipe(imgs[0], True)
        profile_frames(pipe, imgs, frames, PORT_KERNELS,
                       f"{label} {routes} cudnn.benchmark=False")
        del pipe, model
        torch.cuda.empty_cache()


def profile(dev, frames=5):
    """Flagship frame time and its device time by stage and by kernel
    (``--profile``), for the default configuration and the kernel-routed
    one (``ROUTED``): 20 timed frames, then ``torch.profiler`` over
    ``frames`` frames; the default configuration again with cuDNN's
    autotuner on."""
    import torch
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.serving import FixedRigPipeline
    imgs = profile_images(dev)
    for label, routes, benches in (("routed", ROUTED, (False,)),
                                   ("default", {}, (False, True))):
        model = FBOCC(dtype=torch.bfloat16, device=dev,
                      generator=torch.Generator().manual_seed(0), **routes)
        pipe = FixedRigPipeline(model, flagship_rig())
        pipe(imgs[0], True)
        for bench in benches:
            torch.backends.cudnn.benchmark = bench
            profile_frames(pipe, imgs, frames, PORT_KERNELS,
                           f"{label} {routes} cudnn.benchmark={bench}")
        if label == "routed":
            del pipe, model
            torch.cuda.empty_cache()
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
    ``steps`` after two warm-up steps), then each step under
    ``torch.profiler``: kernel time per step, device idle share, the top
    kernels (and K7's share) and the host ops that take the most CPU time
    themselves (``--profile``)."""
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
    cuda = torch.autograd.DeviceType.CUDA
    for k7 in (True, False):
        ms = float(np.mean(times[k7]))
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step(k7)
            torch.cuda.synchronize()
        ev = prof.key_averages()
        dkey = ("device_time_total" if hasattr(ev[0], "device_time_total")
                else "cuda_time_total")
        dt = (lambda e: getattr(e, dkey) / 1e3 / steps)
        kern = [e for e in ev if e.device_type == cuda]
        total = sum(dt(e) for e in kern)
        ours = sum(dt(e) for e in kern if "conv3x3_" in e.key
                   or "split_sum" in e.key)
        label = "K7" if k7 else "cuDNN"
        log(f"flagship train step with {label} convs {ms:.3f} ms (mean of "
            f"the two turns); kernel time {total:.3f} ms: device idle share "
            f"{max(0.0, 1 - total / ms):.3f}"
            + (f"; K7 {ours:.3f} ms" if k7 else ""))
        for e in sorted(kern, key=dt, reverse=True)[:20 if k7 else 8]:
            log(f"  train kernel {dt(e):8.3f} ms x{e.count // steps:<4d} "
                f"{e.key[:90]}")
        # host: the ops that spend the most CPU time themselves
        host = sorted((e for e in ev if e.device_type != cuda),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        for e in host[:12]:
            log(f"  {label} host op {e.self_cpu_time_total / 1e3 / steps:8.3f}"
                f" ms self x{e.count // steps:<5d} {e.key[:70]}")


def kernel_name(mangled):
    """A readable name of a kernel from its mangled one: the last name of
    its nested name with its integer template arguments
    (``conv3x3_wgmma<2,256>``); others as they are."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    i, name = m.end(), None
    while True:  # the length-prefixed components of the nested name
        m = re.match(r"(\d+)", mangled[i:])
        if not m:
            break
        j = i + m.end()
        name, i = mangled[j:j + int(m.group(1))], j + int(m.group(1))
    if name is None:
        return mangled
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
    if args:
        name += "<" + ",".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
    return name


def ptxas_summary(log_text):
    """Registers, spills and stack of each kernel from an ``nvcc -Xptxas
    -v`` log: ``name regs R spill S/L`` (S bytes of spill stores, L of
    spill loads), `` stack F`` where it has an F-byte stack frame (local
    memory)."""
    out, name, spill, stack = [], None, "?", 0
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spill, stack = kernel_name(m.group(1)), "?", 0
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            stack, spill = int(m.group(1)), f"{m.group(2)}/{m.group(3)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} regs {m.group(1)} spill {spill}"
                       + (f" stack {stack}" if stack else ""))
    return " | ".join(out)


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
            text = f.read()
        log(f"  {os.path.basename(so)}: {ptxas_summary(text)}")
        for ln in text.splitlines():
            if "warning" in ln.lower():
                log(f"  {os.path.basename(so)}: {ln.strip()}")
    if "--profile" in sys.argv[1:]:
        profile(dev)
        profile_train(dev)
        return 0
    if "--profile-default" in sys.argv[1:]:
        profile_default(dev)
        return 0
    if "--profile-occ" in sys.argv[1:]:
        profile_occ(dev)
        return 0
    if "--k1" in sys.argv[1:]:
        # K1 (both variants) and K5 alone, for iterating on them: their
        # ptxas lines, then K5's plan sweep
        log(f"fuse_warp.cu ptxas: {lib_ptxas('fuse_warp')}")
        check_k1(dev, epilogue=True)
        check_k1(dev, epilogue=False)
        check_k5(dev, sweep=True)
        log(f"chip_smoke --k1: {time.perf_counter() - T0:.1f} s")
        return 0
    if "--pool" in sys.argv[1:]:
        # K2 alone, after its ptxas lines, with its plan sweep
        log(f"bev_pool.cu ptxas: {lib_ptxas('bev_pool')}")
        check_k2(dev, sweep=True)
        log(f"chip_smoke --pool: {time.perf_counter() - T0:.1f} s")
        return 0
    if "--msda" in sys.argv[1:]:
        # K3, K4 and K10 alone (msda.cu), after their ptxas lines
        log(f"msda.cu ptxas: {lib_ptxas('msda')}")
        check_k3(dev, "msda", 6, 16 * 44, (16, 44), 4096, 8)
        check_k3(dev, "msda_selfattn", 1, 10000, (100, 100), 10000, 4)
        check_k10(dev)
        log(f"chip_smoke --msda: {time.perf_counter() - T0:.1f} s")
        return 0
    if "--occ" in sys.argv[1:]:
        # K9 and K8 alone, for iterating on them
        log(f"occ_tail.cu ptxas: {lib_ptxas('occ_tail')}")
        check_k9(dev)
        check_k8(dev)
        log(f"chip_smoke --occ: {time.perf_counter() - T0:.1f} s")
        return 0
    if "--loop" in sys.argv[1:]:
        # the training and evaluation loop alone (run_loop)
        run_loop(dev)
        log(f"chip_smoke --loop: {time.perf_counter() - T0:.1f} s")
        return 0
    if "--config" in sys.argv[1:]:
        # the config-built entry alone (run_config)
        run_config(dev)
        log(f"chip_smoke --config: {time.perf_counter() - T0:.1f} s")
        return 0
    if "--k6-plans" in sys.argv[1:]:
        k6_plans(dev)
        return 0
    if "--k7-plans" in sys.argv[1:]:
        k7_plans(dev)
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
    routed = [check_k5(dev), check_k6(dev), check_k8(dev), check_k9(dev)]
    k10 = check_k10(dev)
    # each serving path with the counts set to 0 just before it
    counts, median_ms = run_stream(dev, "default", FRAMES)
    log(f"flagship median frame {median_ms:.2f} ms (frames 2..{FRAMES})")
    for k in kernels:
        k["launches"] = counts[k["name"]]
    counts_r, median_r = run_stream(dev, "routed", FRAMES, **ROUTED)
    counts_b, median_b = run_stream(dev, "blend", 3, **BLEND)
    log(f"median frame: default {median_ms:.2f} ms, routed {median_r:.2f} "
        f"ms, blend {median_b:.2f} ms")
    for k in routed:
        k["launches"] = (counts_b if k["name"] == "occ_fuse"
                         else counts_r)[k["name"]]
    # on no path: its count, 0 in every stream (each checked against
    # PER_FRAME), as the default stream read it
    k10["launches"] = counts[k10["name"]]
    run_small_parity(dev)
    run_small_parity(dev, **ROUTED)
    train_counts, step_ms, peak = run_train(dev)
    for k in k7:
        k["launches"] = train_counts[k["name"]]
    k1_t1, k1_f32 = run_config(dev)
    loop_train, loop_eval = run_loop(dev)
    for k in kernels:
        k["loop_launches"] = loop_eval[k["name"]]
    for k in k7:
        k["loop_launches"] = loop_train[k["name"]]
    kernels[3].update(t1_ms=k1_t1["ms"], t1_graph_ms=k1_t1["graph_ms"],
                      t1_plain_ms=k1_t1["plain_ms"],
                      t1_bound_ms=k1_t1["bound_ms"],
                      t1_max_abs_err=k1_t1["max_abs_err"])
    log(f"chip_smoke: {time.perf_counter() - T0:.1f} s")
    log(json.dumps({"kernels": kernels + [k1_f32] + k7 + routed + [k10]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
