# FB-OCC R50 16-frame flagship -- the TPU-native equivalent of the
# reference's occupancy_configs/fb_occ/fbocc-r50-cbgs_depth_16f_16x4_20e.py.
_base_ = ["_base_/default_runtime.py"]

point_cloud_range = [-40.0, -40.0, -1.0, 40.0, 40.0, 5.4]

grid_config = dict(
    x=(-40.0, 40.0, 0.8),
    y=(-40.0, 40.0, 0.8),
    z=(-1.0, 5.4, 0.8),
    depth=(2.0, 42.0, 0.5),
)

grid_config_bevformer = dict(
    x=(-40.0, 40.0, 0.8),
    y=(-40.0, 40.0, 0.8),
    z=(-1.0, 5.4, 1.6),
)

data_config = dict(
    cams=["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
          "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT"],
    Ncams=6,
    input_size=(256, 704),
    src_size=(900, 1600),
    resize=(-0.06, 0.11),
    rot=(-5.4, 5.4),
    flip=True,
    crop_h=(0.0, 0.0),
    resize_test=0.0,
)

bda_aug_conf = dict(
    rot_lim=(-22.5, 22.5), scale_lim=(1.0, 1.0),
    flip_dx_ratio=0.5, flip_dy_ratio=0.5)

model = dict(
    type="FBOCC",
    grid_config=grid_config,
    bevformer_grid_config=grid_config_bevformer,
    input_size=data_config["input_size"],
    downsample=16,
    num_cams=6,
    backbone_depth=50,
    img_feat_channels=256,
    single_bev_num_channels=80,
    depth_channels=80,
    history_cat_num=16,
    history_cat_conv_out_channels=160,
    readd=True,
    num_classes=19,
    use_backward_projection=True,
    use_depth_supervision=True,
    voxel_channels=(64, 128, 256),
    voxel_out_channels=256,
    pc_range=tuple(point_cloud_range),
    dtype="bfloat16",
    remat=True,
)

data = dict(
    type="NuScenesDataset",
    data_root="data/nuscenes/",
    ann_file_train="data/nuscenes/bevdetv2-nuscenes_infos_train.pkl",
    ann_file_val="data/nuscenes/bevdetv2-nuscenes_infos_val.pkl",
    occupancy_path="data/occupancy_cvpr2023/gts",
    data_config=data_config,
    bda_aug_conf=bda_aug_conf,
    grid_config=grid_config,
    batch_size=4,
    train_sequences_split_num=2,
    test_sequences_split_num=1,
)

# training recipe (config :359-394 of the reference)
optimizer = dict(base_lr=2e-4, weight_decay=1e-2, max_grad_norm=5.0,
                 warmup_iters=200, warmup_ratio=1e-3)
num_epochs = 20
num_iters_per_epoch = 2001  # int(28130 // 64 * 4.554), 16x4 global batch
ema = dict(base_decay=0.999, init_updates=10560)
temporal_start_iter = 2 * num_iters_per_epoch
max_iters = num_epochs * num_iters_per_epoch
