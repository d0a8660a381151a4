"""Occupancy mIoU and F-score evaluation on the host (numpy).  The port's
own copy of ``fbbev_tpu/evaluation/occ_metrics.py``.

Parity reference: ``Metric_mIoU``
(``mmdet3d/datasets/occ_metrics.py:50-179``): 18-class
confusion matrix (17 semantics + free) over camera-visible voxels, with a
radial distance gate on the BEV plane; mIoU averages classes 0..16
(``count_miou`` excludes the free class).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

CLASS_NAMES = [
    "others", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation", "free",
]


class MIoUMetric:
    def __init__(self, num_classes: int = 18, use_image_mask: bool = True,
                 min_d: float = -1.0, max_d: float = 100.0,
                 bev_extent_m: float = 80.0):
        self.num_classes = num_classes
        self.use_image_mask = use_image_mask
        self.hist = np.zeros((num_classes, num_classes), np.int64)
        self.cnt = 0
        self.min_d, self.max_d = min_d, max_d
        self.bev_extent_m = bev_extent_m
        self._gate = {}

    def _distance_gate(self, hw: int) -> np.ndarray:
        """Radial gate for an hw x hw BEV (reference: 200 cells x 0.4 m)."""
        if hw not in self._gate:
            voxel = self.bev_extent_m / hw
            xx, yy = np.meshgrid(np.arange(hw), np.arange(hw))
            dist = np.linalg.norm(
                (np.stack([yy, xx], -1) - hw / 2) * voxel, axis=-1)
            self._gate[hw] = (dist <= self.max_d) & (dist >= self.min_d)
        return self._gate[hw]

    def add_batch(self, semantics_pred: np.ndarray, semantics_gt: np.ndarray,
                  mask_camera: Optional[np.ndarray] = None):
        """Args: (H, W, Z) int label volumes in CVPR2023 axes."""
        self.cnt += 1
        if mask_camera is None:
            mask_camera = np.ones(semantics_gt.shape, bool)
        mask = mask_camera & self._distance_gate(
            semantics_gt.shape[0])[:, :, None]
        gt = semantics_gt[mask]
        pred = semantics_pred[mask]
        k = (gt >= 0) & (gt < self.num_classes)
        self.hist += np.bincount(
            self.num_classes * gt[k].astype(np.int64) + pred[k].astype(
                np.int64),
            minlength=self.num_classes ** 2,
        ).reshape(self.num_classes, self.num_classes)

    def per_class_iou(self) -> np.ndarray:
        diag = np.diag(self.hist)
        denom = self.hist.sum(1) + self.hist.sum(0) - diag
        with np.errstate(divide="ignore", invalid="ignore"):
            return diag / denom

    def count_miou(self) -> Dict[str, float]:
        iou = self.per_class_iou()
        res = {}
        for i in range(self.num_classes - 1):
            res[CLASS_NAMES[i]] = round(float(iou[i]) * 100, 2)
        res["Overall"] = round(
            float(np.nanmean(iou[: self.num_classes - 1])) * 100, 2)
        return res


class FScoreMetric:
    """Binary-occupancy F-score (``Metric_FScore``,
    ``mmdet3d/datasets/occ_metrics.py:182-281``).

    The reference queries KDTrees between the two occupied-voxel-centre
    point clouds and thresholds the NN distance.  Because every point is a
    voxel centre on the same regular grid, ``min_dist < t`` is *exactly* a
    binary dilation of the other occupancy grid by the integer offsets
    with ``||d .* voxel_size|| < t`` -- so the KDTree is replaced by an
    offset-shift OR, with identical results and no spatial-index
    dependency.  Dataset-eval parameters: thresholds 0.4
    (``nuscenes_dataset.py:702-711``), void = {17, 255}.

    Boundary note: when the threshold falls exactly on a lattice distance
    (0.4 with 0.4 voxels), the reference's ``dist < t`` is fp-rounding
    dependent (adjacent-centre distances evaluate to 0.4 +/- 1ulp varying
    by position); here the strict inequality is exact, i.e. the 0.4
    default counts only coincident voxels.
    """

    def __init__(self, threshold_acc: float = 0.4,
                 threshold_complete: float = 0.4,
                 voxel_size=(0.4, 0.4, 0.4), void=(17, 255),
                 use_image_mask: bool = True):
        self.threshold_acc = threshold_acc
        self.threshold_complete = threshold_complete
        self.voxel_size = tuple(voxel_size)
        self.void = tuple(void)
        self.use_image_mask = use_image_mask
        self.cnt = 0
        self.tot_acc = 0.0
        self.tot_cmpl = 0.0
        self.tot_f1 = 0.0
        self.eps = 1e-8

    def _offsets(self, threshold: float):
        vx, vy, vz = self.voxel_size
        rx = int(np.ceil(threshold / vx))
        ry = int(np.ceil(threshold / vy))
        rz = int(np.ceil(threshold / vz))
        offs = []
        for dx in range(-rx, rx + 1):
            for dy in range(-ry, ry + 1):
                for dz in range(-rz, rz + 1):
                    d = np.linalg.norm([dx * vx, dy * vy, dz * vz])
                    if d < threshold:
                        offs.append((dx, dy, dz))
        return offs

    @staticmethod
    def _dilate(occ: np.ndarray, offsets) -> np.ndarray:
        out = np.zeros_like(occ)
        H, W, Z = occ.shape
        for dx, dy, dz in offsets:
            src = occ[max(0, -dx):H - max(0, dx),
                      max(0, -dy):W - max(0, dy),
                      max(0, -dz):Z - max(0, dz)]
            out[max(0, dx):H - max(0, -dx),
                max(0, dy):W - max(0, -dy),
                max(0, dz):Z - max(0, -dz)] |= src
        return out

    def add_batch(self, semantics_pred: np.ndarray, semantics_gt: np.ndarray,
                  mask_camera: np.ndarray = None):
        """(H, W, Z) int label volumes in CVPR2023 axes (same contract as
        :meth:`MIoUMetric.add_batch`)."""
        self.cnt += 1
        gt = semantics_gt.copy()
        pred = semantics_pred.copy()
        if self.use_image_mask and mask_camera is not None:
            gt[~mask_camera.astype(bool)] = 255
            pred[~mask_camera.astype(bool)] = 255
        gt_occ = ~np.isin(gt, self.void)
        pred_occ = ~np.isin(pred, self.void)
        if not pred_occ.any():
            # reference: empty prediction scores 0 (occ_metrics.py:252-255)
            return
        # completeness: GT points with a predicted point within t_complete
        near_pred = self._dilate(pred_occ,
                                 self._offsets(self.threshold_complete))
        completeness = float(near_pred[gt_occ].mean()) if gt_occ.any() else 0.
        # accuracy: predicted points with a GT point within t_acc
        near_gt = self._dilate(gt_occ, self._offsets(self.threshold_acc))
        accuracy = float(near_gt[pred_occ].mean())
        f1 = 2.0 / (1.0 / (accuracy + self.eps)
                    + 1.0 / (completeness + self.eps))
        self.tot_acc += accuracy
        self.tot_cmpl += completeness
        self.tot_f1 += f1

    def count_fscore(self) -> Dict[str, float]:
        return {"f-score": round(self.tot_f1 / max(self.cnt, 1), 4)}
