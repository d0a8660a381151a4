"""Evaluate a trained model over the val split, from the latest
checkpoint under the work dir: streaming occupancy mIoU, and for a
detection config (``fbbev-r50-det_16f.py``) the nuScenes mAP, TP errors
and NDS.  Prints every key :func:`~fbbev_tpu_torch.train.loop.evaluate`
returns.  Counterpart of the JAX package's ``tools/test.py``, with its
flags and ``--device``.

Usage:

    python -m fbbev_tpu_torch.tools.test <config> --work-dir <dir> \\
        [--max-samples N] [--no-ema] [--out-csv results.csv] \\
        [--cfg-options key=value ...] [--device cuda|cpu]

On several GPUs, one process per rank (``--space S`` splits each
sample's cameras and BEV rows over S ranks; the confusion matrix is
summed over the data ranks and rank 0 prints and writes the results):

    torchrun --standalone --nproc_per_node 2 -m fbbev_tpu_torch.tools.test \
        <config> --work-dir <dir> --devices 2 [--space 2]
"""

from __future__ import annotations

import argparse
import csv
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate an fbbev_tpu_torch model")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--out-csv", default=None,
                   help="append the results (per-class IoU, mAP, NDS, "
                   "...) to a results.csv")
    p.add_argument("--devices", default=None,
                   help="mesh size: the number of ranks (torchrun "
                        "processes) or 'all'")
    p.add_argument("--space", type=int, default=None,
                   help="camera- and BEV-row-parallel mesh axis size")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Prints and returns :func:`~fbbev_tpu_torch.train.loop.evaluate`'s
    results."""
    args = parse_args(argv)
    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.train.loop import evaluate

    cfg = Config.fromfile(args.config)
    overrides = dict(kv.split("=", 1) for kv in args.cfg_options)
    for flag in ("devices", "space"):
        v = getattr(args, flag)
        if v is not None:
            overrides[flag] = str(v)
    cfg.merge_from_options(overrides)
    if args.devices is not None or args.space is not None:
        from fbbev_tpu_torch.parallel import distributed_init_if_needed
        distributed_init_if_needed(args.device)
    results = evaluate(cfg, max_samples=args.max_samples,
                       use_ema=not args.no_ema, work_dir=args.work_dir,
                       device=args.device)
    if torch.distributed.is_initialized() and torch.distributed.get_rank():
        return results
    for k, v in results.items():
        print(f"{k}: {v}")
    if args.out_csv:
        write_header = not os.path.exists(args.out_csv)
        with open(args.out_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(results))
            if write_header:
                w.writeheader()
            w.writerow(results)
    return results


if __name__ == "__main__":
    main()
