"""Train an FB-OCC model from a config file on one device.  Counterpart of
the JAX package's ``tools/train.py``, with its flags and ``--device``.

Usage:

    python -m fbbev_tpu_torch.tools.train <config> --work-dir <dir> \\
        [--max-iters N] [--resume] [--load-from ckpt.pth|params.npz] \\
        [--load-img-from ckpt.pth] [--cfg-options key=value ...] \\
        [--device cuda|cpu]

Checkpoints (about 1.1 GB each at the flagship, the newest 3 kept) and
logs go under ``--work-dir``, else the config's ``work_dir`` relative to
the working directory: give a directory outside the source tree.
``--devices`` / ``--space`` (a device mesh) raise: multi-GPU training is
ROADMAP M14.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train an fbbev_tpu_torch model")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--devices", default=None,
                   help="mesh size (ROADMAP M14; raises)")
    p.add_argument("--space", type=int, default=None,
                   help="camera/model-parallel mesh axis size (M14; raises)")
    p.add_argument("--load-from", default=None,
                   help="warm-start checkpoint (.pth or a JAX .npz)")
    p.add_argument("--load-img-from", default=None,
                   help="partial warm start: image backbone only "
                        "(reference tools/train.py:277-299)")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dotted key=value config overrides")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns :func:`~fbbev_tpu_torch.train.loop.train`'s result."""
    args = parse_args(argv)
    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.train.loop import train

    cfg = Config.fromfile(args.config)
    overrides = dict(kv.split("=", 1) for kv in args.cfg_options)
    for flag in ("devices", "space", "load_from", "load_img_from"):
        v = getattr(args, flag)
        if v is not None:
            overrides[flag] = str(v)
    cfg.merge_from_options(overrides)
    return train(cfg, max_iters=args.max_iters, work_dir=args.work_dir,
                 resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
