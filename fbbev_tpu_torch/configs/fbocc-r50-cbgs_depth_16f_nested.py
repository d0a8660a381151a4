# Flagship FB-OCC expressed in the REFERENCE's nested component-config
# schema (cf. occupancy_configs/fb_occ/fbocc-r50-cbgs_depth_16f_16x4_20e.py)
# -- demonstrates drop-in support for the config-driven model-zoo API.
_base_ = ["_base_/default_runtime.py"]

point_cloud_range = [-40.0, -40.0, -1.0, 40.0, 40.0, 5.4]
grid_config = dict(x=(-40.0, 40.0, 0.8), y=(-40.0, 40.0, 0.8),
                   z=(-1.0, 5.4, 0.8), depth=(2.0, 42.0, 0.5))
grid_config_bevformer = dict(x=(-40.0, 40.0, 0.8), y=(-40.0, 40.0, 0.8),
                             z=(-1.0, 5.4, 1.6))
numC_Trans = 80

model = dict(
    type="FBOCC",
    use_depth_supervision=True,
    history_cat_num=16,
    history_cat_conv_out_channels=160,
    single_bev_num_channels=numC_Trans,
    readd=True,
    dtype="bfloat16",
    img_backbone=dict(
        type="ResNet", depth=50, num_stages=4, out_indices=(2, 3),
        with_cp=True, style="pytorch"),
    img_neck=dict(
        type="CustomFPN", in_channels=[1024, 2048], out_channels=256,
        num_outs=1, start_level=0, out_ids=[0]),
    depth_net=dict(
        type="CM_DepthNet", in_channels=256, context_channels=numC_Trans,
        downsample=16, grid_config=grid_config, depth_channels=80,
        loss_depth_weight=1.0, use_dcn=False),
    forward_projection=dict(
        type="LSSViewTransformerFunction3D", grid_config=grid_config,
        input_size=(256, 704), downsample=16),
    frpn=None,
    backward_projection=dict(
        type="BackwardProjection", bev_h=100, bev_w=100,
        in_channels=numC_Trans, out_channels=numC_Trans,
        pc_range=point_cloud_range,
        transformer=dict(
            type="BEVFormer", embed_dims=numC_Trans,
            encoder=dict(
                type="bevformer_encoder", num_layers=1,
                pc_range=point_cloud_range,
                grid_config=grid_config_bevformer)),
    ),
    img_bev_encoder_backbone=dict(
        type="CustomResNet3D", depth=18, with_cp=True,
        block_strides=[1, 2, 2], n_input_channels=numC_Trans,
        block_inplanes=[64, 128, 256], out_indices=(0, 1, 2)),
    img_bev_encoder_neck=dict(
        type="FPN3D", with_cp=True, in_channels=[64, 128, 256],
        out_channels=256),
    occupancy_head=dict(
        type="OccHead", use_focal_loss=True, soft_weights=True,
        final_occ_size=[200, 200, 16], empty_idx=18, num_level=3,
        in_channels=[256, 256, 256], out_channel=19,
        point_cloud_range=point_cloud_range),
    pts_bbox_head=None,
)

data = dict(
    type="SyntheticClipDataset", n_scenes=2, frames_per_scene=4,
    input_size=(256, 704), num_cams=6, occ_shape=(200, 200, 16),
    batch_size=1)
optimizer = dict(base_lr=2e-4, weight_decay=1e-2, max_grad_norm=5.0,
                 warmup_iters=200, warmup_ratio=1e-3)
ema = dict(base_decay=0.999, init_updates=10560)
temporal_start_iter = 4002
max_iters = 40020
