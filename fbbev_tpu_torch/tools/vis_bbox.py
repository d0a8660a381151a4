"""Render 3D detections as a BEV image (boxes over the ego frame).  The
port's own copy of the JAX package's ``tools/vis_bbox.py``, its corners
from :func:`fbbev_tpu_torch.ops.boxes.boxes_bev_corners`.

Input: an .npz with ``boxes`` (N, >=7), ``scores`` (N,), ``labels`` (N,)
in ego coordinates, optional ``gt_boxes`` / ``gt_labels``.

Usage:

    python -m fbbev_tpu_torch.tools.vis_bbox dets.npz --out bbox_vis.png \\
        [--score-thresh 0.3] [--extent 40] [--px-per-m 8]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fbbev_tpu_torch.ops.boxes import boxes_bev_corners


def draw_boxes(draw, boxes, color, pc_range, scale, width=2):
    if len(boxes) == 0:
        return
    corners = boxes_bev_corners(torch.from_numpy(
        np.asarray(boxes, np.float32))).numpy()
    for quad in corners:
        pts = [(float((x - pc_range[0]) * scale),
                float((y - pc_range[1]) * scale)) for x, y in quad]
        draw.polygon(pts, outline=color, width=width)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Draw 3D boxes in BEV")
    p.add_argument("input", help=".npz with boxes/scores/labels")
    p.add_argument("--out", default="bbox_vis.png")
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--extent", type=float, default=40.0)
    p.add_argument("--px-per-m", type=float, default=8.0)
    return p.parse_args(argv)


def main(argv=None):
    """Writes the image; returns the number of predictions drawn."""
    args = parse_args(argv)
    from PIL import Image, ImageDraw

    data = np.load(args.input)
    size = int(2 * args.extent * args.px_per_m)
    img = Image.new("RGB", (size, size), (30, 30, 30))
    draw = ImageDraw.Draw(img)
    pc_range = (-args.extent, -args.extent)
    # ego marker
    c = size // 2
    draw.ellipse([c - 4, c - 4, c + 4, c + 4], fill=(255, 255, 255))

    if "gt_boxes" in data:
        draw_boxes(draw, data["gt_boxes"], (0, 255, 0), pc_range,
                   args.px_per_m)
    boxes = data["boxes"]
    keep = data["scores"] >= args.score_thresh
    draw_boxes(draw, boxes[keep], (255, 80, 80), pc_range, args.px_per_m)
    img.save(args.out)
    print(f"wrote {args.out}: {int(keep.sum())} predictions"
          + (f", {len(data['gt_boxes'])} GT" if "gt_boxes" in data else ""))
    return int(keep.sum())


if __name__ == "__main__":
    main()
