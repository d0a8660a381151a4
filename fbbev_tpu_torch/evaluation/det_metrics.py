"""nuScenes-style 3D detection metrics (mAP, TP errors, NDS).  The port's
own copy of ``fbbev_tpu/evaluation/det_metrics.py`` (numpy only, on the
host): the same protocol, the same results dict.

The protocol the reference runs through the nuScenes devkit
(mmdet3d ``datasets/nuscenes_eval.py``; ``nuscenes_dataset.py:769+``
evaluate_bbox):

* per class x distance threshold {0.5, 1, 2, 4} m: greedy center-distance
  matching by descending score, AP = mean precision over recall in
  [0.1, 1] (101-point interpolation, devkit convention);
* TP errors at the 2 m threshold: ATE (center L2), ASE (1 - aligned IoU),
  AOE (yaw delta, period 2pi except pi for barriers), AVE (velocity L2),
  AAE (1 - attribute accuracy);
* NDS = (5*mAP + sum_tp (1 - min(1, err))) / 10.

The model predicts no attributes (neither does the reference's CenterPoint
head); like the reference's submission writer
(``nuscenes_dataset.py:496-515``), the *predicted* attribute is derived
from class + speed: moving vehicles -> 'vehicle.moving', moving cycles ->
'cycle.with_rider', slow pedestrians -> 'pedestrian.standing', slow buses
-> 'vehicle.stopped', else the per-class default.  GT attributes come from
the annotated names when the loader provides them (``gt_attrs``, plumbed
from the info pickles); the heuristic is only the fallback.  Per the
devkit: barrier is excluded from mAVE/mAAE, traffic_cone from
mAOE/mAVE/mAAE, and TP entries whose GT has no attribute are excluded
from mAAE.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1

# nuscenes_dataset.py:92-103
DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}


def derive_attribute(name: str, vx: float, vy: float) -> str:
    """Class+speed attribute heuristic (nuscenes_dataset.py:496-515)."""
    if np.sqrt(vx * vx + vy * vy) > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck",
                    "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return DEFAULT_ATTRIBUTE.get(name, "")
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE.get(name, "")


def _aligned_iou_3d(dims_a: np.ndarray, dims_b: np.ndarray) -> np.ndarray:
    inter = np.prod(np.minimum(dims_a, dims_b), axis=-1)
    union = np.prod(dims_a, -1) + np.prod(dims_b, -1) - inter
    return inter / np.maximum(union, 1e-6)


def _yaw_diff(a, b, period=2 * np.pi):
    d = (a - b) % period
    return np.minimum(d, period - d)


class DetectionMetric:
    """Accumulates per-sample predictions/GT; computes mAP/TP/NDS."""

    def __init__(self, class_names: Sequence[str]):
        self.class_names = list(class_names)
        # per class: list of (score, matched@thr dict, tp_errors or None)
        self.preds: Dict[str, List] = {c: [] for c in self.class_names}
        self.n_gt: Dict[str, int] = {c: 0 for c in self.class_names}

    def add_sample(self, boxes: np.ndarray, scores: np.ndarray,
                   labels: np.ndarray, gt_boxes: np.ndarray,
                   gt_labels: np.ndarray,
                   gt_attrs: Optional[Sequence[str]] = None):
        """boxes/gt_boxes: (N, >=9) [x,y,z,dx,dy,dz,yaw,vx,vy]; invalid
        predictions have score < 0.  ``gt_attrs``: per-GT attribute names;
        when absent they are derived from GT velocity with the same
        heuristic as predictions (real-data loaders pass the annotated
        attributes)."""
        valid = scores >= 0
        boxes, scores, labels = boxes[valid], scores[valid], labels[valid]
        for ci, cname in enumerate(self.class_names):
            p_idx = np.where(labels == ci)[0]
            g_idx = np.where(gt_labels == ci)[0]
            self.n_gt[cname] += len(g_idx)
            order = p_idx[np.argsort(-scores[p_idx])]
            taken = {thr: np.zeros(len(g_idx), bool)
                     for thr in DIST_THRESHOLDS}
            for pi in order:
                center = boxes[pi, :2]
                if len(g_idx):
                    d = np.linalg.norm(
                        gt_boxes[g_idx, :2] - center[None], axis=1)
                else:
                    d = np.empty((0,))
                entry_matches = {}
                tp_err = None
                for thr in DIST_THRESHOLDS:
                    match = -1
                    if len(d):
                        cand = np.where((d < thr) & ~taken[thr])[0]
                        if len(cand):
                            match = cand[np.argmin(d[cand])]
                            taken[thr][match] = True
                    entry_matches[thr] = match >= 0
                    if thr == TP_THRESHOLD and match >= 0:
                        g = gt_boxes[g_idx[match]]
                        period = np.pi if cname == "barrier" else 2 * np.pi
                        gt_attr = (
                            gt_attrs[g_idx[match]] if gt_attrs is not None
                            else derive_attribute(cname, g[7], g[8]))
                        pred_attr = derive_attribute(
                            cname, boxes[pi, 7], boxes[pi, 8])
                        tp_err = dict(
                            ate=float(d[match]),
                            ase=1.0 - float(_aligned_iou_3d(
                                boxes[pi, 3:6], g[3:6])),
                            aoe=float(_yaw_diff(boxes[pi, 6], g[6], period)),
                            ave=float(np.linalg.norm(
                                boxes[pi, 7:9] - g[7:9])),
                            # devkit: attr error undefined (excluded) when
                            # the GT has no attribute
                            aae=(None if gt_attr == "" else
                                 float(pred_attr != gt_attr)),
                        )
                self.preds[cname].append(
                    (float(scores[pi]), entry_matches, tp_err))

    # ------------------------------------------------------------------
    def _class_ap(self, cname: str, thr: float) -> float:
        n_gt = self.n_gt[cname]
        if n_gt == 0:
            return float("nan")
        entries = sorted(self.preds[cname], key=lambda e: -e[0])
        tp = np.array([e[1][thr] for e in entries], np.float64)
        if len(tp) == 0:
            return 0.0
        fp = 1.0 - tp
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        # 101-point interpolation on the recall grid (devkit convention)
        r_grid = np.linspace(0, 1, 101)
        p_interp = np.zeros_like(r_grid)
        for i, r in enumerate(r_grid):
            mask = recall >= r
            p_interp[i] = precision[mask].max() if mask.any() else 0.0
        p_interp = np.clip(p_interp - MIN_PRECISION, 0, 1)
        p_interp[r_grid < MIN_RECALL] = 0.0
        return float(p_interp.sum() / ((1 - MIN_RECALL)
                                       * (1 - MIN_PRECISION) * 101))

    # devkit convention (nuscenes-devkit evaluate.py): barrier has no
    # velocity/attribute; traffic_cone additionally has no orientation --
    # those TP errors are excluded (np.nan) from the class means.
    TP_EXCLUDE = {
        "barrier": ("ave", "aae"),
        "traffic_cone": ("aoe", "ave", "aae"),
    }

    def compute(self) -> Dict[str, float]:
        aps = {}
        tp_errs = {k: [] for k in ("ate", "ase", "aoe", "ave", "aae")}
        for cname in self.class_names:
            class_aps = [self._class_ap(cname, t) for t in DIST_THRESHOLDS]
            aps[cname] = float(np.nanmean(class_aps))
            errs = [e[2] for e in self.preds[cname] if e[2] is not None]
            excluded = self.TP_EXCLUDE.get(cname, ())
            for k in tp_errs:
                if k in excluded:
                    continue
                vals = [er[k] for er in errs] if errs else []
                vals = [v for v in vals if v is not None]
                if vals:
                    tp_errs[k].append(np.mean(vals))
        mean_ap = float(np.nanmean(list(aps.values())))
        results = {f"AP_{c}": v for c, v in aps.items()}
        results["mAP"] = mean_ap
        tp_score = 0.0
        for k, vals in tp_errs.items():
            err = float(np.mean(vals)) if vals else 1.0
            results[f"m{k.upper()}"] = err
            tp_score += max(0.0, 1.0 - min(1.0, err))
        n_tp = len(tp_errs)
        results["NDS"] = float(
            (5 * mean_ap + tp_score) * (1.0 / (5 + n_tp)))
        return results
