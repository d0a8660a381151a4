"""Evaluation of the port: occupancy mIoU, F-score and the CVPR-frame
prediction format, nuScenes detection mAP / NDS (numpy, on the host)."""

from fbbev_tpu_torch.evaluation.det_metrics import DetectionMetric
from fbbev_tpu_torch.evaluation.format import occ_pred_to_cvpr_format
from fbbev_tpu_torch.evaluation.occ_metrics import FScoreMetric, MIoUMetric

__all__ = ["DetectionMetric", "FScoreMetric", "MIoUMetric",
           "occ_pred_to_cvpr_format"]
