# FB-OCC large variant: VoVNet-99 backbone at 512x1408 (BASELINE config #4;
# cf. the challenge-scale FB-OCC models).
_base_ = ["fbocc-r50-cbgs_depth_16f.py"]

model = dict(
    backbone_type="VoVNetCP",
    backbone_arch="V-99-eSE",
    input_size=(512, 1408),
)

data = dict(
    data_config=dict(input_size=(512, 1408)),
    batch_size=2,
)
