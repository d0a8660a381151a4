"""Dataset wrappers: class-balanced (CBGS) resampling and repetition.  The
port's own copy of ``fbbev_tpu/data/wrappers.py``.

Parity reference: ``mmdet3d/datasets/dataset_wrappers.py:8-80``
(``CBGSDataset``, the class-balanced grouping & sampling of
arXiv:1908.09492) and the ``RepeatDataset`` branch of
``datasets/builder.py:43-46``.

Differences from the reference, by design:

* Sampling is **seeded** (explicit ``seed`` arg) instead of consuming the
  global ``np.random`` state — runs are reproducible and independent of
  import order.
* The wrapper validates that the base dataset is non-temporal-sampled
  use only in spirit: CBGS scatters within-scene adjacency, so (like the
  reference, which only applies it to detection configs) it should wrap
  datasets consumed by shuffling samplers, not the stream-per-slot
  temporal sampler.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from fbbev_tpu_torch.registry import DATASETS


@DATASETS.register
class CBGSDataset:
    """Class-balanced resampling wrapper (``dataset_wrappers.py:8-80``).

    For each class ``c`` with sample-index list ``I_c`` (a sample appears
    in every class it contains), draws ``int(len(I_c) * ratio_c)`` samples
    with replacement where ``ratio_c = (1/num_classes) / p_c`` and
    ``p_c = len(I_c) / sum_c len(I_c)`` — i.e. every class contributes the
    same expected number of resampled scenes.

    The wrapped dataset must expose ``get_cat_ids(idx) -> list[int]``;
    ``flag`` (sequence/group ids) is remapped through the sample indices
    exactly like the reference (:25-27).
    """

    def __init__(self, dataset, num_classes: Optional[int] = None,
                 seed: int = 0):
        self.dataset = dataset
        classes = getattr(dataset, "CLASSES", None)
        if num_classes is None:
            if classes is None:
                raise ValueError(
                    "num_classes not given and dataset has no CLASSES")
            num_classes = len(classes)
        self.CLASSES = classes
        self.num_classes = int(num_classes)
        self.sample_indices = self._get_sample_indices(
            np.random.RandomState(seed))
        if hasattr(dataset, "flag"):
            self.flag = np.asarray(
                [dataset.flag[i] for i in self.sample_indices],
                dtype=np.int64)

    def _get_sample_indices(self, rng: np.random.RandomState):
        class_sample_idxs = {c: [] for c in range(self.num_classes)}
        for idx in range(len(self.dataset)):
            for cat_id in self.dataset.get_cat_ids(idx):
                if 0 <= cat_id < self.num_classes:
                    class_sample_idxs[cat_id].append(idx)
        duplicated = sum(len(v) for v in class_sample_idxs.values())
        if duplicated == 0:
            return list(range(len(self.dataset)))
        frac = 1.0 / self.num_classes
        sample_indices = []
        for cls_inds in class_sample_idxs.values():
            if not cls_inds:
                continue
            ratio = frac / (len(cls_inds) / duplicated)
            sample_indices += rng.choice(
                cls_inds, int(len(cls_inds) * ratio)).tolist()
        return sample_indices

    def get_cat_ids(self, idx: int):
        return self.dataset.get_cat_ids(self.sample_indices[idx])

    def __getitem__(self, idx: int):
        return self.dataset[self.sample_indices[idx]]

    def __len__(self) -> int:
        return len(self.sample_indices)


@DATASETS.register
class RepeatDataset:
    """Repeat a dataset ``times`` times (``datasets/builder.py:43-46``) —
    amortises per-epoch bookkeeping for small datasets."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = int(times)
        self.CLASSES = getattr(dataset, "CLASSES", None)
        if hasattr(dataset, "flag"):
            self.flag = np.tile(np.asarray(dataset.flag), self.times)

    def get_cat_ids(self, idx: int):
        return self.dataset.get_cat_ids(idx % len(self.dataset))

    def __getitem__(self, idx: int):
        return self.dataset[idx % len(self.dataset)]

    def __len__(self) -> int:
        return self.times * len(self.dataset)
