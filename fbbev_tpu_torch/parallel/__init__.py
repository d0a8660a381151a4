"""Multi-GPU scale-out: the ('data', 'space') mesh on
``torch.distributed``.  Counterpart of ``fbbev_tpu/parallel``."""

from fbbev_tpu_torch.parallel.mesh import (  # noqa: F401
    CAMERA_KEYS, Axis, Mesh, active_mesh, all_gather, all_reduce_,
    all_reduce_sum, barrier, bn_axis, broadcast_, distributed_init_if_needed,
    gather_to_host, local_device, make_mesh, replicate,
    shard_batch, split_cameras, sync_batch_norm, use_mesh)
