# Full-size flagship model on synthetic data: on-chip training smoke test
# (proves the complete 256x704 / 16-frame training graph compiles and
# steps on real hardware without nuScenes files).
_base_ = ["fbocc-r50-cbgs_depth_16f.py"]

model = dict(remat=True)

data = dict(
    _delete_=True,
    type="SyntheticClipDataset",
    n_scenes=2,
    frames_per_scene=4,
    input_size=(256, 704),
    num_cams=6,
    occ_shape=(200, 200, 16),
    batch_size=1,
)

optimizer = dict(warmup_iters=10)
temporal_start_iter = 3
max_iters = 12
log_interval = 3
checkpoint_interval = 1000000
