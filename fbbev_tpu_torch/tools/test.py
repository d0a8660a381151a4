"""Evaluate a trained model: streaming occupancy mIoU over the val split,
from the latest checkpoint under the work dir.  Counterpart of the JAX
package's ``tools/test.py``, with its flags and ``--device``.

Usage:

    python -m fbbev_tpu_torch.tools.test <config> --work-dir <dir> \\
        [--max-samples N] [--no-ema] [--out-csv results.csv] \\
        [--cfg-options key=value ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import csv
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate an fbbev_tpu_torch model")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--out-csv", default=None,
                   help="append per-class IoU to a results.csv")
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
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    results = evaluate(cfg, max_samples=args.max_samples,
                       use_ema=not args.no_ema, work_dir=args.work_dir,
                       device=args.device)
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
