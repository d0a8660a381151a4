"""Data of the port: datasets, samplers, wrappers, the prefetching loader
and batch collation; the exports of ``fbbev_tpu/data``.  numpy on the
host: PIL is imported only where an image is read."""

from fbbev_tpu_torch.data.nuscenes import NuScenesDataset, \
    compute_sequence_flags
from fbbev_tpu_torch.data.sampler import EvalGroupStreamSampler, \
    InfiniteGroupStreamSampler
from fbbev_tpu_torch.data.synthetic import SyntheticClipDataset, collate
from fbbev_tpu_torch.data.wrappers import CBGSDataset, RepeatDataset

__all__ = ["CBGSDataset", "EvalGroupStreamSampler",
           "InfiniteGroupStreamSampler", "NuScenesDataset", "RepeatDataset",
           "SyntheticClipDataset", "collate", "compute_sequence_flags"]
