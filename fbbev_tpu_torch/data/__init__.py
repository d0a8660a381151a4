"""Data of the port: the synthetic clip dataset and batch collation."""

from fbbev_tpu_torch.data.synthetic import SyntheticClipDataset, collate

__all__ = ["SyntheticClipDataset", "collate"]
