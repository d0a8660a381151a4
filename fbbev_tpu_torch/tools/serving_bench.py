"""Config-general serving benchmark: the ``FixedRigPipeline`` deploy graph
(BatchNorms folded) streaming frames, for any model config.  Counterpart
of the JAX package's ``tools/serving_bench.py``.

The rig-static index math is hoisted out of the measured frames (the
pipeline's construction); each frame is one streaming step that carries
the temporal state.  ``--chunk`` staged frames make a round, one device
sync ends it; after a first round (which builds the kernels) ``--rounds``
rounds are timed on the host clock.  Serves int8 by default, as the JAX
tool: the image trunk's convs calibrated on the first two frames
(``FixedRigPipeline.enable_int8``) and run on the int8 conv kernel, the
scales cached in a JSON file under ``quantize.code_cache_key`` (``--scales``
names it; reused while the key matches); ``--no-int8`` serves in the
config's dtype.  Prints one JSON line.

Usage:
    python -m fbbev_tpu_torch.tools.serving_bench \\
        fbbev_tpu_torch/configs/fbocc-r50-cbgs_depth_16f.py
    python -m fbbev_tpu_torch.tools.serving_bench <config> --device cpu
    python -m fbbev_tpu_torch.tools.serving_bench <config> --no-int8
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
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
    p.add_argument("--no-int8", action="store_true",
                   help="serve in the config's dtype, no int8 convs")
    p.add_argument("--scales", default=None,
                   help="JSON file of cached int8 scales (default: one per "
                        "config in the temporary directory)")
    args = p.parse_args(argv)

    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.serving import FixedRigPipeline
    from fbbev_tpu_torch.utils import quantize as Q
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
    if not args.no_int8:
        # calibrated on a sequence start and the first staged frame, as
        # the JAX tool; the scales reused while their key matches
        key = Q.code_cache_key(tag, (H, W), int(cfg.get("seed", 0)))
        path = args.scales or os.path.join(
            tempfile.gettempdir(), f"fbbev_torch_int8_scales_{tag}.json")
        scales = None
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            if data.get("key") == key:
                scales = Q.scales_from_json(data["scales"])
        if scales is not None:
            pipe.qparams = Q.build_qparams(model, scales)
        else:
            calib = [frame(0, B, N, H, W, dev), staged[0]]
            pipe.enable_int8(
                [im for im, _ in calib],
                [dict(start_of_sequence=i == 0, curr_to_prev_ego_rt=rt)
                 for i, (_, rt) in enumerate(calib)])
            with open(path, "w") as f:
                json.dump({"key": key, "scales": Q.scales_to_json(
                    pipe._int8_scales)}, f)

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
        "int8": not args.no_int8,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
