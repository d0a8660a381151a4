"""Prediction-format conversion to the CVPR2023 occupancy challenge axes.
The port's own copy of ``fbbev_tpu/evaluation/format.py`` (numpy).

Parity reference: ``FBOCC.simple_test``
(``mmdet3d/models/fbbev/detectors/fbocc.py:536-554``):
drop the void class (fix_void), softmax, then permute/flip/rot90 back into
the Occ3D (X, Y, Z) frame -- the exact inverse of the GT conversion in
``LoadOccupancy`` (``loading.py:197-200``).
"""

from __future__ import annotations

import numpy as np


def occ_pred_to_cvpr_format(logits: np.ndarray,
                            fix_void: bool = True) -> np.ndarray:
    """(Y, X, Z, C) occupancy logits -> (X, Y, Z) CVPR-frame label volume."""
    if fix_void:
        logits = logits[..., 1:]
    # softmax is monotonic per-voxel; argmax after the axis shuffle matches
    # the reference (it softmaxes for optional score output first).
    v = np.transpose(logits, (3, 2, 0, 1))      # (C, Z, Y, X)
    v = np.flip(v, 2)                            # flip Y
    v = np.rot90(v, -1, (2, 3))                  # rot90 in (Y, X)
    v = np.transpose(v, (2, 3, 1, 0))            # (X', Y', Z, C)
    return np.argmax(v, axis=-1).astype(np.int32)
