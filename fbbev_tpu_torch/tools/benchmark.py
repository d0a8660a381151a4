"""Inference or train-step latency for any config and batch size.
Counterpart of the JAX package's ``tools/benchmark.py``.

Inference is the ``Trainer``'s eval step (the model's forward on the EMA
weights, BatchNorms folded); ``--train-step`` times the train step
instead.  Both run on one synthetic batch (``SyntheticClipDataset``),
warmed up by one call, then ``--iters`` calls on the host clock ended by
a device sync.  Prints one JSON line.

Usage:
    python -m fbbev_tpu_torch.tools.benchmark [<config>] [--train-step]
    python -m fbbev_tpu_torch.tools.benchmark <config> --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "fbocc-r50-cbgs_depth_16f.py")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", nargs="?", default=DEFAULT_CONFIG)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--train-step", action="store_true",
                   help="benchmark the training step instead of inference")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.data import SyntheticClipDataset, collate
    from fbbev_tpu_torch.models.fbocc import init_temporal_state
    from fbbev_tpu_torch.train import Trainer
    from fbbev_tpu_torch.train.loop import _grid_size, build_model
    from fbbev_tpu_torch.utils.fuse_bn import build_folded

    dev = torch.device(args.device)
    cfg = Config.fromfile(args.config)
    g = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    model = (build_model(cfg, device=dev, generator=g) if args.train_step
             else build_folded(cfg, device=dev, generator=g))
    B = args.batch_size
    grid = _grid_size(model)
    ds = SyntheticClipDataset(
        n_scenes=max(B, 2), frames_per_scene=8,
        input_size=model.input_size, num_cams=model.num_cams,
        occ_shape=tuple(2 * n for n in grid[:2]) + (16,))
    tstate = init_temporal_state(B, grid, model.history_cat_num,
                                 model.single_bev_num_channels,
                                 dtype=model.dtype, device=dev)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in collate([ds[i * 8] for i in range(B)]).items()}
    trainer = Trainer(model)
    state = trainer.init_state()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if args.train_step:
        def step(state, tstate):
            return trainer.train_step(state, tstate, batch)[:2]
        name = "train_step"
    else:
        def step(state, tstate):
            return state, trainer.eval_step(state, tstate, batch)[1]
        name = "inference"
    state, tstate = step(state, tstate)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, tstate = step(state, tstate)
    sync()
    dt = (time.perf_counter() - t0) / args.iters
    line = {
        "metric": f"{name}_latency_ms", "value": round(dt * 1e3, 2),
        "batch_size": B,
        "frames_per_sec": round(B / dt, 2),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
