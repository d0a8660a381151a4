# Long-horizon flagship training smoke (VERDICT r4 #8): ~2k iters of the
# full 256x704 / 16-frame recipe on synthetic data -- optimizer + EMA +
# curriculum flip at temporal_start_iter + periodic streaming eval +
# orbax checkpoints (killed and --resume'd mid-run).
# The compressed analogue of the reference's 40k-iter IterBasedRunner
# recipe (occupancy config fbocc-r50-cbgs_depth_16f_16x4_20e.py:9-13,
# 359-394): every hook fires multiple times within the horizon.
_base_ = ["fbocc-r50_synthetic_smoke.py"]

max_iters = 2000
temporal_start_iter = 500      # curriculum flip lands mid-run
log_interval = 50
checkpoint_interval = 400      # several checkpoints; resume target ~1200
eval_interval = 700            # streaming EMA eval fires at 700 / 1400
eval_max_samples = 4
optimizer = dict(warmup_iters=200)
work_dir = "work_dirs/long_smoke"
