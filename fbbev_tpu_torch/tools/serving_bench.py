"""Config-general serving benchmark: the ``FixedRigPipeline`` deploy graph
(BatchNorms folded) streaming frames, for any model config.  Counterpart
of the JAX package's ``tools/serving_bench.py``.

The rig-static index math is hoisted out of the measured frames (the
pipeline's construction); each frame is one streaming step that carries
the temporal state.  ``--chunk`` staged frames make a round, one device
sync ends it; after a first round (which builds the kernels) ``--rounds``
rounds are timed on the host clock.  Serves in the config's dtype: the
int8 engine of the JAX tool is ROADMAP M13 (``"int8": false``).  Prints
one JSON line.

Usage:
    python -m fbbev_tpu_torch.tools.serving_bench \\
        fbbev_tpu_torch/configs/fbocc-r50-cbgs_depth_16f.py
    python -m fbbev_tpu_torch.tools.serving_bench <config> --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def fixed_rig(N: int, H: int, W: int, B: int = 1):
    """The JAX tool's synthetic rig: N cameras at the origin spread in yaw,
    focal 560 * W / 704 scaled by 0.44 in the image plane."""
    from fbbev_tpu_torch import geometry
    intr = np.diag([560. * W / 704., 560. * W / 704., 1.]).astype(
        np.float32)
    intr[0, 2], intr[1, 2] = W / 2., H / 2.
    rots = np.stack([geometry.rot_z(a) for a in np.linspace(
        0, 2 * np.pi, N, endpoint=False)])[None]
    post_rot = (np.eye(3) * 0.44 + np.diag([0., 0., .56])).astype(
        np.float32)
    f32 = (lambda a: torch.tensor(a, dtype=torch.float32))
    return geometry.CamParams(
        rots=f32(np.broadcast_to(rots, (B, N, 3, 3))),
        trans=torch.zeros(B, N, 3),
        intrins=f32(np.broadcast_to(intr, (B, N, 3, 3))),
        post_rots=f32(np.broadcast_to(post_rot, (B, N, 3, 3))),
        post_trans=torch.zeros(B, N, 3), bda=torch.eye(3).expand(B, 3, 3))


def frame(seed: int, B: int, N: int, H: int, W: int, device):
    """Images on ``device`` and the curr->prev ego motion (numpy) of one
    staged frame: the identity plus a small random translation."""
    r = np.random.RandomState(seed)
    imgs = torch.from_numpy(r.randn(B, N, H, W, 3).astype(np.float32))
    rt = (np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
          + np.pad(r.randn(B, 3, 1).astype(np.float32) * 0.01,
                   ((0, 0), (0, 1), (3, 0))))
    return imgs.to(device), rt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--chunk", type=int, default=16,
                   help="frames per round, one device sync at its end")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.serving import FixedRigPipeline
    from fbbev_tpu_torch.utils.fuse_bn import build_folded

    dev = torch.device(args.device)
    tag = os.path.splitext(os.path.basename(args.config))[0]
    cfg = Config.fromfile(args.config)
    model = build_folded(cfg, device=dev, generator=torch.Generator()
                         .manual_seed(int(cfg.get("seed", 0))))
    B, N = 1, model.num_cams
    H, W = model.input_size
    pipe = FixedRigPipeline(model, fixed_rig(N, H, W, B))
    staged = [frame(i + 1, B, N, H, W, dev) for i in range(4)]
    frames = staged * max(1, args.chunk // len(staged))

    def round_():
        for imgs, rt in frames:
            pipe(imgs, False, rt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    round_()
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        round_()
    dt = (time.perf_counter() - t0) / (args.rounds * len(frames))
    line = {
        "metric": f"{tag}_serving_fps_per_chip",
        "value": round(B / dt, 2),
        "unit": f"{N}-cam frames/sec/chip",
        "latency_ms": round(dt * 1e3, 2),
        "int8": False,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
