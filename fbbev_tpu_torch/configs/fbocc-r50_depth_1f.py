# FB-OCC R50 single-frame (no temporal fusion; BASELINE configs #1-2):
# history length 1 with the curriculum permanently off reproduces the
# forward(+backward)-projection-only model.
_base_ = ["fbocc-r50-cbgs_depth_16f.py"]

model = dict(
    history_cat_num=1,
    history_cat_conv_out_channels=160,
)

temporal_start_iter = 10 ** 9  # never enable history streaming
