"""nuScenes dataset over the bevdetv2 info pickle.  The port's own copy
of ``fbbev_tpu/data/nuscenes.py``: the same samples, numpy arrays on the
host.

Parity reference: ``NuScenesDataset``
(``mmdet3d/datasets/nuscenes_dataset.py:28-384``):
``img_info_prototype='bevdet'`` info dicts, sequence grouping with
``sequences_split_num``, per-sample temporal metadata
(``sequence_group_idx`` / ``start_of_sequence`` / ``curr_to_prev_ego_rt``).

A sample is returned as a flat dict of numpy arrays matching the model's
batch schema (see ``fbbev_tpu_torch.models.fbocc.FBOCC.forward``).
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from fbbev_tpu_torch.data import transforms as T
from fbbev_tpu_torch.registry import DATASETS


def compute_sequence_flags(infos: List[Dict],
                           sequences_split_num: int = 1) -> np.ndarray:
    """Group samples into scene sequences, optionally splitting each into
    ``sequences_split_num`` sub-sequences (:241-276)."""
    flags = []
    curr = 0
    for idx, info in enumerate(infos):
        if idx != 0 and len(info.get("prev", [])) == 0:
            curr += 1
        flags.append(curr)
    flags = np.asarray(flags, np.int64)
    if sequences_split_num == 1:
        return flags
    if sequences_split_num == "all":
        return np.arange(len(infos), dtype=np.int64)
    bin_counts = np.bincount(flags)
    new_flags = []
    curr_new = 0
    for curr_flag in range(len(bin_counts)):
        n = bin_counts[curr_flag]
        bounds = list(range(0, n, math.ceil(n / sequences_split_num))) + [n]
        for sub_len in np.diff(bounds):
            new_flags.extend([curr_new] * sub_len)
            curr_new += 1
    assert len(new_flags) == len(flags)
    return np.asarray(new_flags, np.int64)


@DATASETS.register
class NuScenesDataset:
    CAM_NAMES = (
        "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
        "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
    )
    # nuScenes detection classes, converter order (tools/create_data.py;
    # ref configs/_base_/datasets/nus-3d.py class_names)
    CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone")

    def __init__(self, ann_file: str, data_config: Dict,
                 bda_aug_conf: Optional[Dict] = None,
                 occupancy_path: Optional[str] = None,
                 grid_config: Optional[Dict] = None,
                 is_train: bool = False,
                 sequences_split_num: int = 1,
                 load_depth: bool = False,
                 load_occupancy: bool = True,
                 fix_void: bool = True,
                 ego_cam: str = "CAM_FRONT",
                 seed: int = 0,
                 tta_config: Optional[Dict] = None,
                 cam_names: Optional[Sequence[str]] = None,
                 max_boxes: int = 300):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        # reference sorts by timestamp inside scenes at converter time
        self.infos = infos
        self.data_config = data_config
        self.bda_aug_conf = bda_aug_conf or dict(
            rot_lim=(0.0, 0.0), scale_lim=(1.0, 1.0), flip_dx_ratio=0.0,
            flip_dy_ratio=0.0)
        self.occupancy_path = occupancy_path
        self.grid_config = grid_config
        self.is_train = is_train
        self.load_depth = load_depth
        self.load_occupancy = load_occupancy
        self.fix_void = fix_void
        self.ego_cam = ego_cam
        self.max_boxes = max_boxes
        if cam_names is not None:
            self.CAM_NAMES = tuple(cam_names)
        self.flag = compute_sequence_flags(self.infos, sequences_split_num)
        self.rng = np.random.RandomState(seed)
        # test-time augmentation: dict(tta_flip=, flip_dx=, flip_dy=).
        # Like the reference (CustomDistMultiScaleFlipAug3D,
        # test_time_aug.py:319-392 + aug_test == assert False), the GT is
        # flipped consistently with the inputs, so each TTA variant is
        # evaluated in its own flipped world and variants merge through the
        # shared confusion matrix -- predictions are never un-flipped.
        self.tta_config = tta_config

    def __len__(self) -> int:
        return len(self.infos)

    def get_cat_ids(self, index: int):
        """Distinct detection-class ids present in a sample — the CBGS
        wrapper's input (ref ``nuscenes_dataset.py:200-222``).  bevdetv2
        infos carry integer labels in ``ann_infos``; converter-era infos
        carry ``gt_names`` strings — both are handled."""
        info = self.infos[index]
        if "ann_infos" in info:
            labels = np.asarray(info["ann_infos"][1], np.int64).reshape(-1)
            return sorted({int(c) for c in labels
                           if 0 <= c < len(self.CLASSES)})
        names = info.get("gt_names", ())
        if "valid_flag" in info:
            mask = np.asarray(info["valid_flag"], bool)
            names = np.asarray(names)[mask]
        cat2id = {n: i for i, n in enumerate(self.CLASSES)}
        return sorted({cat2id[n] for n in set(names) if n in cat2id})

    # ------------------------------------------------------------------
    def _temporal_meta(self, index: int) -> Dict[str, np.ndarray]:
        start = index == 0 or self.flag[index - 1] != self.flag[index]
        if not start:
            c2p = T.nuscenes_rt_matrix(
                self.infos[index], self.infos[index - 1], "ego", "ego")
        else:
            c2p = np.eye(4)
        return dict(
            sequence_group_idx=np.int32(self.flag[index]),
            start_of_sequence=np.bool_(start),
            curr_to_prev_ego_rt=c2p.astype(np.float32),
        )

    # ------------------------------------------------------------------
    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        info = self.infos[index]
        imgs, rots, trans, intrins, post_rots, post_trans = \
            [], [], [], [], [], []
        img_augs_per_cam = []
        for cam_name in self.CAM_NAMES:
            cam = info["cams"][cam_name]
            img = Image.open(cam["data_path"])
            aug = T.sample_image_augmentation(
                self.data_config, img.height, img.width, self.is_train,
                self.rng,
                flip=(bool(self.tta_config.get("tta_flip", False))
                      if self.tta_config and not self.is_train else None))
            resize, resize_dims, crop, flip, rotate = aug
            img_augs_per_cam.append(aug)
            img = T.apply_image_transform(img, resize_dims, crop, flip,
                                          rotate)
            post_rot2, post_tran2 = T.update_post_homography(
                np.eye(2, dtype=np.float32), np.zeros(2, np.float32),
                resize, crop, flip, rotate)
            post_rot = np.eye(3, dtype=np.float32)
            post_tran = np.zeros(3, np.float32)
            post_rot[:2, :2] = post_rot2
            post_tran[:2] = post_tran2

            s2ke = T.sensor2keyego(info, info, cam_name, self.ego_cam)
            imgs.append(T.normalize_image(np.asarray(img.convert("RGB"))))
            rots.append(s2ke[:3, :3].astype(np.float32))
            trans.append(s2ke[:3, 3].astype(np.float32))
            intrins.append(np.asarray(cam["cam_intrinsic"], np.float32))
            post_rots.append(post_rot)
            post_trans.append(post_tran)

        rotate_bda, scale_bda, flip_dx, flip_dy = T.sample_bda_augmentation(
            self.bda_aug_conf, self.is_train, self.rng,
            tta_config=self.tta_config)
        bda_rot = T.bda_matrix(rotate_bda, scale_bda, flip_dx, flip_dy)

        sample: Dict[str, np.ndarray] = dict(
            imgs=np.stack(imgs),
            rots=np.stack(rots), trans=np.stack(trans),
            intrins=np.stack(intrins),
            post_rots=np.stack(post_rots), post_trans=np.stack(post_trans),
            bda=bda_rot,
            **self._temporal_meta(index),
        )
        sample["index"] = np.int32(index)

        if "ann_infos" in info:
            ann = info["ann_infos"]
            boxes, labels = ann[0], ann[1]
            attrs = list(ann[2]) if len(ann) > 2 else None
            boxes = np.asarray(boxes, np.float32).reshape(-1, 9)
            boxes, _ = T.transform_boxes_bda(
                boxes, rotate_bda, scale_bda, flip_dx, flip_dy)
            # pad to a fixed count so batches collate with static
            # shapes; label -1 marks padding (centerpoint_targets and
            # DetectionMetric both ignore it)
            n = min(len(boxes), self.max_boxes)
            out_boxes = np.zeros((self.max_boxes, 9), np.float32)
            out_labels = np.full((self.max_boxes,), -1, np.int64)
            out_boxes[:n] = boxes[:n]
            out_labels[:n] = np.asarray(labels, np.int64)[:n]
            sample["gt_boxes"] = out_boxes
            sample["gt_labels"] = out_labels
            if attrs is not None and not self.is_train:
                # annotated attribute names for the NDS mAAE term
                # (host-side strings; excluded from device batches)
                out_attrs = np.full((self.max_boxes,), "", dtype="<U48")
                out_attrs[:n] = np.asarray(attrs, dtype="<U48")[:n]
                sample["gt_attrs"] = out_attrs

        if self.load_occupancy and self.occupancy_path is not None:
            occ = T.load_occupancy_gt(
                self.occupancy_path, info["scene_name"], info["token"],
                rotate_bda, flip_dx, flip_dy, ignore_nonvisible=self.is_train,
                fix_void=self.fix_void)
            sample["gt_occupancy"] = occ["gt_occupancy"]
            if not self.is_train:
                sample["visible_mask"] = occ["visible_mask"]
                sample["gt_occupancy_cvpr"] = occ["gt_occupancy_cvpr"]

        if self.load_depth and "lidar_path" in info:
            sample["gt_depth"] = self._lidar_depth(
                info, intrins, post_rots, post_trans, img_augs_per_cam)
        return sample

    # ------------------------------------------------------------------
    def _lidar_depth(self, info, intrins, post_rots, post_trans, _augs):
        """Project the LiDAR sweep into every camera and rasterise
        min-depth maps (PointToMultiViewDepth:877-960)."""
        pts = np.fromfile(info["lidar_path"], np.float32).reshape(-1, 5)
        pts = pts[:, :3]
        H, W = self.data_config["input_size"]
        lidarego2global = T._pose(info["ego2global_rotation"],
                                  info["ego2global_translation"])
        depth_maps = []
        for cid, cam_name in enumerate(self.CAM_NAMES):
            cam = info["cams"][cam_name]
            cam2camego = T._pose(cam["sensor2ego_rotation"],
                                 cam["sensor2ego_translation"])
            camego2global = T._pose(cam["ego2global_rotation"],
                                    cam["ego2global_translation"])
            cam2img = np.eye(4)
            cam2img[:3, :3] = intrins[cid]
            lidar2cam = np.linalg.inv(camego2global @ cam2camego) @ \
                lidarego2global
            lidar2img = cam2img @ lidar2cam
            p = pts @ lidar2img[:3, :3].T + lidar2img[:3, 3]
            p = np.concatenate(
                [p[:, :2] / np.maximum(p[:, 2:3], 1e-5), p[:, 2:3]], 1)
            p = p @ post_rots[cid].T + post_trans[cid]
            depth_maps.append(T.points_to_depth_map(
                p, H, W, self.grid_config["depth"]))
        return np.stack(depth_maps).astype(np.float32)
