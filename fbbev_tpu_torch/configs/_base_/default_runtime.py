# Shared runtime defaults (cf. the reference's
# occupancy_configs/_base_/default_runtime.py -- NCCL/dist settings become
# mesh settings here).
log_interval = 50
checkpoint_interval = 1000
work_dir = "work_dirs"
mesh = dict(data=None, space=1)  # data=None -> all remaining devices
seed = 0
