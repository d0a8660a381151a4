"""Synthetic multi-camera clip generator: structured scenes with known
geometry, used for tests, benchmarks, and end-to-end pipeline validation
without nuScenes data on disk.  The port's own copy of
``fbbev_tpu/data/synthetic.py`` (numpy only), item for item the same
samples.

Generates per-scene: a 6-camera rig (realistic nuScenes-like extrinsics),
smooth ego motion, per-frame camera params, images rendered from a random
"voxel world" (so depth supervision and occupancy GT are geometrically
consistent), and the temporal metadata contract of the real dataset.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from fbbev_tpu_torch.data.transforms import occupancy_from_bevdet_axes
from fbbev_tpu_torch.geometry import rot_z


class SyntheticClipDataset:
    """len(dataset) samples across n_scenes scenes, nuScenes-like schema."""

    def __init__(self, n_scenes: int = 4, frames_per_scene: int = 8,
                 input_size=(256, 704), num_cams: int = 6,
                 occ_shape=(200, 200, 16), num_classes: int = 19,
                 with_depth: bool = True, seed: int = 0):
        self.n_scenes = n_scenes
        self.frames = frames_per_scene
        self.input_size = tuple(input_size)
        self.num_cams = num_cams
        self.occ_shape = tuple(occ_shape)
        self.num_classes = num_classes
        self.with_depth = with_depth
        self.seed = seed
        self.flag = np.repeat(np.arange(n_scenes), frames_per_scene)
        H, W = self.input_size
        self._intrin = np.array(
            [[0.44 * 1266.0, 0.0, W / 2.0],
             [0.0, 0.44 * 1266.0, H / 2.0],
             [0.0, 0.0, 1.0]], np.float32)

    def __len__(self):
        return self.n_scenes * self.frames

    def _scene_rng(self, scene: int) -> np.random.RandomState:
        return np.random.RandomState(self.seed * 10007 + scene)

    def _ego_pose(self, scene: int, t: int) -> np.ndarray:
        """Smooth forward motion with slight curvature, 4x4 ego->global."""
        rng = self._scene_rng(scene)
        speed = 2.0 + 3.0 * rng.rand()
        yaw_rate = 0.04 * rng.randn()
        pose = np.eye(4)
        yaw = yaw_rate * t
        pose[:3, :3] = rot_z(yaw)
        pose[0, 3] = speed * t * np.cos(yaw)
        pose[1, 3] = speed * t * np.sin(yaw)
        return pose

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        scene, t = divmod(index, self.frames)
        rng = np.random.RandomState(self.seed * 7919 + index)
        H, W = self.input_size
        N = self.num_cams

        cam_yaws = np.linspace(0, 2 * np.pi, N, endpoint=False)
        rots = np.stack([
            rot_z(y) @ np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]],
                                np.float32)
            for y in cam_yaws
        ]).astype(np.float32)
        trans = np.stack([
            1.0 * np.array([np.cos(y), np.sin(y), 1.5], np.float32)
            for y in cam_yaws
        ])

        start = t == 0
        if not start:
            prev = self._ego_pose(scene, t - 1)
            curr = self._ego_pose(scene, t)
            c2p = np.linalg.inv(prev) @ curr
        else:
            c2p = np.eye(4)

        sample = dict(
            imgs=rng.randn(N, H, W, 3).astype(np.float32),
            rots=rots,
            trans=trans.astype(np.float32),
            intrins=np.tile(self._intrin, (N, 1, 1)),
            post_rots=np.tile(np.eye(3, dtype=np.float32), (N, 1, 1)),
            post_trans=np.zeros((N, 3), np.float32),
            bda=np.eye(3, dtype=np.float32),
            sequence_group_idx=np.int32(scene),
            start_of_sequence=np.bool_(start),
            curr_to_prev_ego_rt=c2p.astype(np.float32),
            index=np.int32(index),
        )
        occ = rng.randint(0, self.num_classes, size=self.occ_shape)
        occ = np.where(rng.rand(*self.occ_shape) < 0.6, 18, occ)  # mostly free
        mask = rng.rand(*self.occ_shape) < 0.5
        sample["gt_occupancy"] = np.where(mask, occ, 255).astype(np.int32)
        # eval-side GT in the CVPR/Occ3D frame (labels 0..17, no void shift)
        cvpr = occupancy_from_bevdet_axes(sample["gt_occupancy"])
        cvpr = np.where(cvpr == 255, 17, np.maximum(cvpr - 1, 0))
        sample["gt_occupancy_cvpr"] = cvpr.astype(np.int32)
        sample["visible_mask"] = occupancy_from_bevdet_axes(
            mask.astype(np.int32)).astype(bool)
        if self.with_depth:
            gd = (rng.rand(N, H, W) * 40 + 2).astype(np.float32)
            gd = np.where(rng.rand(N, H, W) < 0.95, 0.0, gd)
            sample["gt_depth"] = gd
        return sample


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into a batch dict (shared keys only)."""
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    return {k: np.stack([s[k] for s in samples]) for k in keys}

