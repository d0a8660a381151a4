"""Occupancy evaluation of the port: mIoU, F-score and the CVPR-frame
prediction format (numpy, on the host)."""

from fbbev_tpu_torch.evaluation.format import occ_pred_to_cvpr_format
from fbbev_tpu_torch.evaluation.occ_metrics import FScoreMetric, MIoUMetric

__all__ = ["FScoreMetric", "MIoUMetric", "occ_pred_to_cvpr_format"]
