"""K1: fused SoloFusion history front end on the ring-slot history.

Replaces the TPU kernel ``fbbev_tpu/ops/pallas_fuse_warp.py:280
fuse_warp`` (``_body``; ``pl.pallas_call`` :392 with the epilogue, :425
without).  Function, per output voxel: the affine trilinear warp of the
z-major ``(B, Z, Y, X, T*C)`` history (align_corners=True index units,
zero outside the volume), the sequence-start reset of every slot to the
unwarped ``curr``, the overwrite of the oldest slot ``hsel`` by ``curr``
in the new history and, with the epilogue, the folded time conv and the
slots' rows of the cat conv: ``sum_t relu(slot_t @ kc + tvec_t*ke + kb)
@ ws[t]``, so the ``T*C``-channel slots never reach device memory.

CUDA kernels (``csrc/fuse_warp.cu``).  With the epilogue (the serving
path): ``fuse_warp_epi``, a block of :data:`BM` = 128 voxels whose 8
gather warps write each slot's warped rows into a shared-memory A stage
and whose 2 consumer warpgroups run both products on ``wgmma`` with the
cat-conv accumulator in registers; ``kc`` and ``ws`` arrive by TMA from
the K-major copies :func:`relayout_epilogue` makes.  :func:`plan_epilogue`
is the kernel's plan (tile, stages, shared-memory bytes) in Python: the
wrapper checks it and hands its byte count to the entry, which refuses a
launch whose count differs from the kernel's.  An f32 history (the JAX
kernel takes one too) goes to ``fuse_warp_epi_f32``: wgmma has no f32
operands, so a block of 64 voxels gathers each slot into shared memory
and runs both products on the FP32 cores (:func:`epilogue_f32_smem`).
Without the epilogue, bf16 or f32: one block of 64 voxels, the 8 corner
rows read directly.  Bound on the card:
bytes (the history read once and the new history written once, 2 x 205 MB
in bf16 at the flagship): about 0.14 ms on an H100 SXM
(``chip_smoke.py``).  The TPU kernel is exact inside its locality contract
(``pallas_fuse_warp.py:40-43``); the kernels and the plain version here
compute the exact warp everywhere, so they agree with it inside that
contract.

Rounding mirrors ``pallas_fuse_warp.py:234-263``: the tent-product weight
is rounded to the history dtype, the warped slot is rounded to it before
``kc``, and ``y1`` is rounded to it before ``ws``; sums are f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fbbev_tpu_torch.ops import _cuda

launches = 0       # bf16 epilogue and no-epilogue launches
f32_launches = 0   # fuse_warp_epi_f32 launches (an f32 history)

BM = 128          # voxels of a block of the epilogue kernel
A_STAGES = 2      # its ring of warped-slot tiles
W_STAGES = 2      # its ring of ws[t] tiles
SMEM_LIMIT = 232448  # shared memory a block may take on an H100
# (C, F) the epilogue kernel is instantiated for (wgmma N = C and F): the
# flagship's and the small config's
EPI_SHAPES = ((80, 160), (64, 128))


class EpiPlan(NamedTuple):
    """The epilogue kernel's plan: ``BM`` voxels a block, ``k_steps``
    64-channel K steps of every tile, the rings' depths, the shared-memory
    bytes of ``fuse_warp.cu::EpiLayout`` and the grid (V tiles, B)."""
    BM: int
    k_steps: int
    a_stages: int
    w_stages: int
    smem: int
    grid: Tuple[int, int]


def plan_epilogue(B: int, Z: int, Y: int, X: int, C: int,
                  F: int) -> EpiPlan:
    """The plan of ``fuse_warp_epi<C, F>`` at these shapes.  Shared memory,
    each tile in 128-byte rows (64 channels of a K step): the A ring (BM
    rows), two warpgroups' A2 tiles (64 rows each), the ws ring (F rows),
    kc^T (C rows), the corner table (BM x 8 int rows and f32 weights), the
    mbarriers, 1024 bytes of alignment slack.  Raises on shapes the kernel
    does not take."""
    if (C, F) not in EPI_SHAPES:
        raise ValueError(f"the CUDA fuse_warp epilogue takes (C, F) in "
                         f"{EPI_SHAPES}, not {(C, F)}")
    ks = -(-C // 64)
    row = 128 * ks
    bars = 4 * A_STAGES + 2 * W_STAGES + 1
    smem = (A_STAGES * BM * row + 2 * 64 * row + W_STAGES * F * row
            + C * row + BM * 8 * 8 + 8 * bars + 1024)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fuse_warp epilogue plan takes {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return EpiPlan(BM, ks, A_STAGES, W_STAGES, smem,
                   (-(-(Z * Y * X) // BM), B))


def epilogue_f32_smem(C: int, F: int) -> int:
    """Shared-memory bytes of ``fuse_warp_epi_f32<C, F>`` (an f32
    history): the corner table of 64 voxels, the tiles A and Y1 (64 rows
    of C + 4 floats each) and kc (C x C floats).  Raises on the (C, F)
    the kernel is not instantiated for."""
    if (C, F) not in EPI_SHAPES:
        raise ValueError(f"the CUDA fuse_warp epilogue takes (C, F) in "
                         f"{EPI_SHAPES}, not {(C, F)}")
    return 64 * 8 * 8 + 2 * 64 * (C + 4) * 4 + C * C * 4


def _corners(mat: torch.Tensor, Z: int, Y: int, X: int):
    """Yield (flat source row (B, V) int64, weight (B, V) f32, valid) for
    the 8 trilinear corners of every output voxel, V in (z, y, x) order."""
    dev = mat.device
    gz, gy, gx = torch.meshgrid(
        torch.arange(Z, dtype=torch.float32, device=dev),
        torch.arange(Y, dtype=torch.float32, device=dev),
        torch.arange(X, dtype=torch.float32, device=dev), indexing="ij")
    gx, gy, gz = (g.reshape(1, -1) for g in (gx, gy, gz))
    m = mat[:, :3, :].float().reshape(-1, 12)[:, :, None]  # (B, 12, 1)
    xs = m[:, 0] * gx + m[:, 1] * gy + m[:, 3] + m[:, 2] * gz
    ys = m[:, 4] * gx + m[:, 5] * gy + m[:, 7] + m[:, 6] * gz
    zs = m[:, 8] * gx + m[:, 9] * gy + m[:, 11] + m[:, 10] * gz
    x0, y0, z0 = torch.floor(xs), torch.floor(ys), torch.floor(zs)
    for k in range(8):
        ix, iy, iz = x0 + (k & 1), y0 + ((k >> 1) & 1), z0 + (k >> 2)
        w = ((1.0 - torch.abs(xs - ix)) * (1.0 - torch.abs(ys - iy))
             * (1.0 - torch.abs(zs - iz)))
        ok = ((ix >= 0) & (ix <= X - 1) & (iy >= 0) & (iy <= Y - 1)
              & (iz >= 0) & (iz <= Z - 1))
        row = ((iz.clamp(0, Z - 1) * Y + iy.clamp(0, Y - 1)) * X
               + ix.clamp(0, X - 1)).long()
        yield row, torch.where(ok, w, torch.zeros_like(w))


def fuse_warp_plain(hist: torch.Tensor, curr: torch.Tensor,
                    mat: torch.Tensor, start: torch.Tensor,
                    hsel: torch.Tensor, epilogue: Optional[dict] = None):
    """Plain version; arguments and results as :func:`fuse_warp`."""
    B, Z, Y, X, TC = hist.shape
    C = curr.shape[-1]
    T = TC // C
    dt = hist.dtype
    h = hist.reshape(B, Z * Y * X, TC)
    warped = torch.zeros(B, Z * Y * X, TC, dtype=torch.float32,
                         device=hist.device)
    for row, w in _corners(mat, Z, Y, X):
        g = torch.gather(h, 1, row[..., None].expand(-1, -1, TC)).float()
        warped = warped + w.to(dt).float()[..., None] * g
    cur = curr.permute(0, 3, 1, 2, 4).reshape(B, Z * Y * X, 1, C).float()
    cur = cur.expand(-1, -1, T, -1).reshape(B, Z * Y * X, TC)
    s = start.float().reshape(B, 1, 1)
    warped = warped * (1.0 - s) + cur * s
    mk = (torch.arange(TC, device=hist.device)[None] // C
          == hsel.reshape(B, 1).long()).float()[:, None, :]
    new_hist = (warped * (1.0 - mk) + cur * mk).to(dt).reshape(
        B, Z, Y, X, TC)
    if epilogue is None:
        slots = warped.to(curr.dtype).reshape(B, Z, Y, X, TC)
        return slots.permute(0, 2, 3, 1, 4), new_hist
    kc = epilogue["kc"].to(dt).float()
    brow = _brow(epilogue)
    ws = epilogue["ws"].to(dt).float()
    F = ws.shape[-1]
    wt = warped.to(dt).float().reshape(B, -1, T, C)
    y1 = torch.relu(torch.matmul(wt, kc) + brow[:, None])
    part = torch.einsum("bvtc,btcf->bvf", y1.to(dt).float(),
                        ws.reshape(B, T, C, F))
    return part.reshape(B, Z, Y, X, F).permute(0, 2, 3, 1, 4), new_hist


def _brow(epi: dict) -> torch.Tensor:
    """(B, T, C) f32 per-slot bias: tvec * ke + kb."""
    return (epi["tvec"].float()[:, :, None] * epi["ke"].float()[None, None]
            + epi["kb"].float()[None, None])


def relayout_epilogue(epi: dict, B: int, T: int, C: int,
                      dtype: torch.dtype = torch.bfloat16):
    """The epilogue's weights as the kernel's TMA reads them, K-major in
    ``dtype``: ``kc^T`` (C, C), row = output channel, and ``ws`` (B, T*C,
    F) as (B*T, F, C), row b*T + t holding slot t's F x C block
    transposed."""
    kc_t = epi["kc"].to(dtype).t().contiguous()
    ws = epi["ws"].to(dtype)
    F = ws.shape[-1]
    ws_t = ws.reshape(B, T, C, F).transpose(2, 3).reshape(B * T, F, C)
    return kc_t, ws_t.contiguous()


def _aligned(*ts: torch.Tensor) -> bool:
    """Every tensor on the card, contiguous and 16-byte aligned (the
    kernels' vector loads and TMA)."""
    return all(t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in ts)


def fuse_warp(hist: torch.Tensor, curr: torch.Tensor, mat: torch.Tensor,
              start: torch.Tensor, hsel: torch.Tensor,
              epilogue: Optional[dict] = None):
    """Fused history warp + ring update (+ conv epilogue).

    Args:
      hist: (B, Z, Y, X, T*C) history, z-major, slot-major channels.
      curr: (B, Y, X, Z, C) current BEV, same dtype as ``hist``.
      mat: (B, 4, 4) flow in index units (identity for start samples).
      start: (B,) bool sequence-start flags.  hsel: (B,) slot to overwrite.
      epilogue: optional dict ``kc`` (C, C), ``ke`` (C,), ``kb`` (C,)
        folded time conv, ``tvec`` (B, T) slot time embeddings, ``ws``
        (B, T*C, F) cat-conv rows in ring-slot order.

    Returns ``(slots (B, Y, X, Z, T*C), new_hist)`` without the epilogue,
    ``(fused_part (B, Y, X, Z, F) f32, new_hist)`` with it.  CUDA tensors
    launch the kernel (a bf16 history with C a multiple of 8, the
    epilogue's products on wgmma; or an f32 one with C a multiple of 4,
    the products on the FP32 cores; with the epilogue (C, F) in
    :data:`EPI_SHAPES`) and raise on inputs it does not take;
    CPU tensors take the plain version.  Raises ``RuntimeError`` when
    grad mode is on and an input requires grad: training fuses history
    with ``FBOCC.fuse_history_aged``.
    """
    _cuda.refuse_grad("fuse_warp (K1)", hist, curr, mat,
                      *(epilogue or {}).values())
    if not hist.is_cuda:
        return fuse_warp_plain(hist, curr, mat, start, hsel, epilogue)
    global launches
    B, Z, Y, X, TC = hist.shape
    C = curr.shape[-1]
    T = TC // C
    if hist.dtype not in (torch.bfloat16, torch.float32) or \
            curr.dtype != hist.dtype:
        raise ValueError(f"the CUDA fuse_warp takes a bf16 or f32 history "
                         f"and curr of its dtype, not {hist.dtype} and "
                         f"{curr.dtype}")
    bf16 = hist.dtype == torch.bfloat16
    if T * C != TC or curr.shape != (B, Y, X, Z, C) or C % (8 if bf16
                                                             else 4):
        raise ValueError(f"shapes {hist.shape} {curr.shape}")
    hist, curr = hist.contiguous(), curr.contiguous()
    mrows = mat[:, :3, :].float().reshape(B, 12).contiguous()
    start_f = start.float().reshape(B).contiguous()
    hsel_i = hsel.to(torch.int32).reshape(B).contiguous()
    new_hist = torch.empty_like(hist)
    common = (hist, curr, mrows, start_f, hsel_i, new_hist)
    stream = _cuda.stream_ptr(hist)
    if epilogue is None:
        slots = torch.empty(B, Y, X, Z, TC, dtype=curr.dtype,
                            device=hist.device)
        if not _aligned(*common, slots):
            raise ValueError("every fuse_warp input must be on the card, "
                             "16-byte aligned")
        _cuda.check(_cuda.entry("fuse_warp", "fbbev_fuse_warp", 7, 7)(
            *(t.data_ptr() for t in common), slots.data_ptr(), B, Z, Y, X,
            C, T, int(bf16), stream), "fuse_warp")
        launches += 1
        return slots, new_hist
    F = epilogue["ws"].shape[-1]
    if tuple(epilogue["ws"].shape) != (B, TC, F) or \
            tuple(epilogue["kc"].shape) != (C, C):
        raise ValueError(f"epilogue kc {tuple(epilogue['kc'].shape)} ws "
                         f"{tuple(epilogue['ws'].shape)} for C={C}, T={T}")
    brow = _brow(epilogue).contiguous()
    fused = torch.empty(B, Y, X, Z, F, dtype=torch.float32,
                        device=hist.device)
    if not bf16:
        smem = epilogue_f32_smem(C, F)
        kc = epilogue["kc"].float().contiguous()
        ws = epilogue["ws"].float().contiguous()
        if not _aligned(*common, kc, ws, brow, fused):
            raise ValueError("every fuse_warp input must be on the card, "
                             "16-byte aligned")
        _cuda.check(_cuda.entry("fuse_warp", "fbbev_fuse_warp_epi_f32", 10,
                                8)(
            hist.data_ptr(), curr.data_ptr(), mrows.data_ptr(),
            start_f.data_ptr(), hsel_i.data_ptr(), kc.data_ptr(),
            brow.data_ptr(), ws.data_ptr(), new_hist.data_ptr(),
            fused.data_ptr(), B, Z, Y, X, C, T, F, smem, stream),
            "fuse_warp")
        global f32_launches
        f32_launches += 1
        return fused, new_hist
    plan = plan_epilogue(B, Z, Y, X, C, F)
    kc_t, ws_t = relayout_epilogue(epilogue, B, T, C)
    if not _aligned(*common, kc_t, ws_t, brow, fused):
        raise ValueError("every fuse_warp input must be on the card, "
                         "16-byte aligned")
    _cuda.check(_cuda.entry("fuse_warp", "fbbev_fuse_warp_epi", 10, 8)(
        hist.data_ptr(), curr.data_ptr(), mrows.data_ptr(),
        start_f.data_ptr(), hsel_i.data_ptr(), kc_t.data_ptr(),
        brow.data_ptr(), ws_t.data_ptr(), new_hist.data_ptr(),
        fused.data_ptr(), B, Z, Y, X, C, T, F, plan.smem, stream),
        "fuse_warp")
    launches += 1
    return fused, new_hist
