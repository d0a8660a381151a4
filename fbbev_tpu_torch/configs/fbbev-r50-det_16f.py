# FB-BEV R50 detection variant: CenterPoint head on the fused BEV,
# occupancy head off (cf. the reference's FB-BEV detection configs with
# pts_bbox_head=CenterHead and the FRPN mask head).
_base_ = ["fbocc-r50-cbgs_depth_16f.py"]

model = dict(
    use_occupancy_head=False,
    use_detection_head=True,
)
