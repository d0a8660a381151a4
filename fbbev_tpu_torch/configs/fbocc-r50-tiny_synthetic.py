# Tiny synthetic-data config: CI smoke runs and multi-chip dryruns.
_base_ = ["_base_/default_runtime.py"]

grid_config = dict(
    x=(-40.0, 40.0, 3.2), y=(-40.0, 40.0, 3.2), z=(-1.0, 5.4, 0.8),
    depth=(2.0, 42.0, 0.5))
grid_config_bevformer = dict(
    x=(-40.0, 40.0, 3.2), y=(-40.0, 40.0, 3.2), z=(-1.0, 5.4, 1.6))

model = dict(
    type="FBOCC",
    grid_config=grid_config,
    bevformer_grid_config=grid_config_bevformer,
    input_size=(64, 176),
    num_cams=2,
    history_cat_num=2,
    voxel_channels=(16, 32, 64),
    voxel_out_channels=32,
    dtype="float32",
)

data = dict(
    type="SyntheticClipDataset",
    n_scenes=4,
    frames_per_scene=4,
    input_size=(64, 176),
    num_cams=2,
    occ_shape=(50, 50, 16),
    batch_size=2,
)

optimizer = dict(base_lr=2e-4, weight_decay=1e-2, max_grad_norm=5.0,
                 warmup_iters=5, warmup_ratio=1e-3)
ema = dict(base_decay=0.999, init_updates=0)
temporal_start_iter = 2
max_iters = 6
num_iters_per_epoch = 3
