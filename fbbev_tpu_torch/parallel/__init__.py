"""Multi-GPU scale-out: the ('data', 'space') mesh on
``torch.distributed``.  Counterpart of ``fbbev_tpu/parallel``."""

from fbbev_tpu_torch.parallel.mesh import (  # noqa: F401
    CAMERA_KEYS, Axis, Mesh, RowSplit, active_mesh, all_gather, all_reduce_,
    all_reduce_sum, barrier, bn_axis, broadcast_, distributed_init_if_needed,
    gather_to_host, halo, local_device, make_mesh, replicate, row_axis,
    shard_batch, split_cameras, split_rows, sync_batch_norm,
    use_mesh)
