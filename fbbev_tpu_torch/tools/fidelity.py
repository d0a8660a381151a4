"""End-to-end numeric fidelity: float32 against the served configuration.
Counterpart of the JAX package's ``tools/fidelity.py``, with its flags
and report keys, and the relative L2 of each stage besides.

Runs the same weights through

  A. float32 compute with the live BatchNorm statistics, and
  B. the served configuration: ``--dtype`` compute (default bf16) with
     the BatchNorms folded, and with ``--int8`` its convs in int8
     (calibrated on the first two stream frames, the image trunk only)

over a short synthetic temporal stream (or, with ``--config``, the first
frames of the config's validation data), then prints per frame the
occupancy argmax agreement, the top-1 logit errors, the per-stage
max-abs errors (depth, context, bev_refined) and the relative L2 of each
stage and of the logits, one JSON line each, then a summary line.
Random weights get ``--bn-warmup`` train-mode passes over the stream
first, so that their BatchNorm statistics normalise the
activations as a trained network's do; ``--ckpt`` reads the port's
checkpoints (``train/checkpoints.py``), ``--ema`` their EMA weights.

Usage:
    python -m fbbev_tpu_torch.tools.fidelity                # flagship, card
    python -m fbbev_tpu_torch.tools.fidelity --small --cpu --int8
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

# the JAX tool's small size
SMALL = dict(
    grid_config={"x": (-40.0, 40.0, 4.0), "y": (-40.0, 40.0, 4.0),
                 "z": (-1.0, 5.4, 0.8), "depth": (2.0, 42.0, 2.0)},
    bevformer_grid_config={"x": (-40.0, 40.0, 4.0), "y": (-40.0, 40.0, 4.0),
                           "z": (-1.0, 5.4, 1.6)},
    input_size=(64, 176), num_cams=2, history_cat_num=4,
    single_bev_num_channels=32, depth_channels=20, backbone_depth=18,
    img_feat_channels=64, depth_mid_channels=64, max_queries_per_cam=256,
    history_cat_conv_out_channels=64, voxel_channels=(32, 64, 128),
    voxel_out_channels=32)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build(size, dev):
    """The float32 FBOCC of the JAX tool's ``small`` or ``flagship`` size,
    random weights from seed 0."""
    from fbbev_tpu_torch.models import FBOCC
    kw = SMALL if size == "small" else {}
    return FBOCC(**kw, device=dev, generator=torch.Generator().manual_seed(0))


def make_stream(B, N, H, W, frames, dev):
    """The JAX tool's synthetic stream: N cameras at the origin spread in
    yaw, focal 0.8 W, seeded noise images, random ego translations after
    the first frame."""
    from fbbev_tpu_torch import geometry
    intr = np.diag([0.8 * W, 0.8 * W, 1.0]).astype(np.float32)
    intr[0, 2], intr[1, 2] = W / 2.0, H / 2.0
    rots = np.stack([geometry.rot_z(a) for a in np.linspace(
        0, 2 * np.pi, N, endpoint=False)])[None]
    out = []
    for i in range(frames):
        r = np.random.RandomState(100 + i)
        c2p = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        if i > 0:
            c2p[:, :3, 3] = r.randn(B, 3) * 0.3
        b = dict(
            imgs=r.randn(B, N, H, W, 3).astype(np.float32),
            rots=np.broadcast_to(rots, (B, N, 3, 3)).astype(np.float32),
            trans=np.zeros((B, N, 3), np.float32),
            intrins=np.broadcast_to(intr, (B, N, 3, 3)).astype(np.float32),
            post_rots=np.broadcast_to(np.eye(3, dtype=np.float32),
                                      (B, N, 3, 3)).copy(),
            post_trans=np.zeros((B, N, 3), np.float32),
            bda=np.broadcast_to(np.eye(3, dtype=np.float32),
                                (B, 3, 3)).copy(),
            start_of_sequence=np.full((B,), i == 0),
            sequence_group_idx=np.zeros((B,), np.int32),
            curr_to_prev_ego_rt=c2p)
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in b.items()})
    return out


def dataset_stream(cfg, frames, dev):
    """The first ``frames`` frames of scene 0 of the config's validation
    data (a checkpoint's BatchNorm statistics are those of its data)."""
    from fbbev_tpu_torch.data import collate
    from fbbev_tpu_torch.train.loop import build_dataset
    ds = build_dataset(cfg, "val")
    scene0 = np.flatnonzero(ds.flag == ds.flag[0])[:frames]
    return [{k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in collate([ds[int(i)]]).items()
             if not k.startswith("gt_")} for i in scene0]


def load_checkpoint(model, ckpt_dir, use_ema):
    """The newest checkpoint of ``ckpt_dir`` into ``model`` (its EMA
    weights and statistics with ``use_ema``); returns its step."""
    from fbbev_tpu_torch.train import Trainer
    from fbbev_tpu_torch.train.checkpoints import latest_step, \
        restore_checkpoint
    trainer = Trainer(model)
    state = restore_checkpoint(os.path.abspath(ckpt_dir),
                               trainer.init_state())
    if use_ema:
        trainer._load(state.ema_params, state.ema_batch_stats)
    else:
        trainer._load(state.params, state.batch_stats)
    return latest_step(os.path.abspath(ckpt_dir))


def fresh_state(model, dev, dtype):
    from fbbev_tpu_torch.models.fbocc import init_temporal_state
    from fbbev_tpu_torch.train.loop import _grid_size
    return init_temporal_state(1, _grid_size(model), model.history_cat_num,
                               model.single_bev_num_channels, dtype=dtype,
                               device=dev)


@torch.no_grad()
def warm_batch_norms(model, stream, passes: int):
    """``passes`` train-mode forwards over ``stream`` (each from a fresh
    temporal state) that move the BatchNorm statistics as training would:
    random init's (mean 0, var 1) do not normalise real activations, and
    their magnitudes compound with depth.  Leaves the model in eval."""
    for _ in range(passes):
        st = fresh_state(model, next(model.parameters()).device,
                         model.dtype)
        for b in stream:
            _, st = model(b, st, train=True)
    model.eval()


@torch.no_grad()
def run_stream(model, stream, dtype, dev, qparams=None):
    """Per frame the eval forward's depth, context, bev_refined and
    occ_logits as float32 numpy; the convs of ``qparams`` in int8."""
    from fbbev_tpu_torch.utils.quantize import quantized_calls
    state = fresh_state(model, dev, dtype)
    outs = []
    with quantized_calls(qparams, model):
        for b in stream:
            o, state = model(b, state, train=False)
            outs.append({k: o[k].float().cpu().numpy() for k in
                         ("depth", "context", "bev_refined", "occ_logits")
                         if k in o})
    return outs


def _rel_l2(b: np.ndarray, a: np.ndarray) -> float:
    """||b - a|| / ||a|| over every element, in float64."""
    a = a.astype(np.float64)
    return float(np.linalg.norm(b.astype(np.float64) - a)
                 / (np.linalg.norm(a) + 1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="serving compute dtype to price against float32")
    ap.add_argument("--no-fold-bn", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="price the int8 serving configuration (calibrated "
                         "on the first two stream frames)")
    ap.add_argument("--bn-warmup", type=int, default=3,
                    help="train-mode passes over the stream to adapt the "
                         "BatchNorm statistics first (0: the initial ones; "
                         "ignored with --ckpt)")
    ap.add_argument("--config", default=None,
                    help="build the model and its eval stream from a "
                         "config file instead of the built-in sizes")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (work_dir/ckpts) of the "
                         "weights to price")
    ap.add_argument("--ema", action="store_true",
                    help="the EMA weights of --ckpt")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    from fbbev_tpu_torch.utils import quantize as Q
    from fbbev_tpu_torch.utils.fuse_bn import float32_conv_state, \
        fold_batch_norms

    dev = torch.device("cpu" if args.cpu else "cuda")
    ckpt_step = None
    if args.config:
        from fbbev_tpu_torch.config import Config
        from fbbev_tpu_torch.train.loop import build_model
        size = os.path.basename(args.config)
        cfg = Config.fromfile(args.config)
        model_a = build_model(cfg, device=dev, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
        stream = dataset_stream(cfg, args.frames, dev)
    else:
        size = "small" if args.small else "flagship"
        model_a = build(size, dev)
        H, W = model_a.input_size
        stream = make_stream(1, model_a.num_cams, H, W, args.frames, dev)

    if args.ckpt:
        ckpt_step = load_checkpoint(model_a, args.ckpt, args.ema)
        args.bn_warmup = 0  # the checkpoint's statistics are the eval ones
    warm_batch_norms(model_a, stream, args.bn_warmup)
    outs_a = run_stream(model_a, stream, torch.float32, dev)

    dt_b = DTYPES[args.dtype]
    model_b = copy.deepcopy(model_a)
    if not args.no_fold_bn:
        fold_batch_norms(model_b)
    model_b.float32_state = float32_conv_state(model_b)
    model_b.cast(dt_b).eval()
    qparams = None
    if args.int8:
        scales = Q.calibrate_model(model_b, stream[:2],
                                   fresh_state(model_b, dev, dt_b))
        qparams = Q.build_qparams(model_b, scales)
        print(json.dumps({"int8_quantized_convs": len(qparams)}))
    outs_b = run_stream(model_b, stream, dt_b, dev, qparams=qparams)

    report = {"size": size, "dtype": args.dtype, "int8": args.int8,
              "fold_bn": not args.no_fold_bn,
              "bn_warmup": args.bn_warmup, "ckpt": args.ckpt,
              "ckpt_step": ckpt_step, "ema": args.ema, "frames": []}
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        fr = {"frame": i}
        la = a["occ_logits"].astype(np.float64)
        lb = b["occ_logits"].astype(np.float64)
        pa, pb = la.argmax(-1), lb.argmax(-1)
        fr["occ_argmax_agreement_pct"] = round(
            100.0 * float((pa == pb).mean()), 3)
        fr["logit_abs_p99"] = round(float(np.percentile(np.abs(la), 99)), 3)
        top_a = np.take_along_axis(la, pa[..., None], -1)
        top_b = np.take_along_axis(lb, pa[..., None], -1)
        fr["top1_logit_max_abs"] = round(float(np.abs(top_a - top_b).max()),
                                         4)
        fr["top1_logit_rms"] = round(
            float(np.sqrt(((top_a - top_b) ** 2).mean())), 5)
        fr["occ_logits_rel_l2"] = round(_rel_l2(lb, la), 6)
        for k in ("depth", "context", "bev_refined"):
            if k in a:
                err = np.abs(a[k].astype(np.float64)
                             - b[k].astype(np.float64))
                ref = np.abs(a[k]).max() + 1e-9
                fr[f"{k}_max_abs"] = round(float(err.max()), 4)
                fr[f"{k}_max_rel_to_peak"] = round(float(err.max() / ref),
                                                   5)
                fr[f"{k}_rel_l2"] = round(_rel_l2(b[k], a[k]), 6)
        report["frames"].append(fr)
        print(json.dumps(fr))
    agree = [f["occ_argmax_agreement_pct"] for f in report["frames"]]
    report["min_agreement_pct"] = min(agree)
    print(json.dumps({"min_agreement_pct": report["min_agreement_pct"],
                      "size": size, "dtype": args.dtype,
                      "fold_bn": report["fold_bn"]}), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
