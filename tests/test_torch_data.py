"""The port's data, metric, logging and profiling modules against the JAX
package's, on the same numpy-seeded inputs.

Everything here is host-side numpy (PIL for the nuScenes images), so the
two packages must agree exactly: every comparison is ``array_equal`` or
``==`` unless a test says otherwise.  The nuScenes dataset reads the
small on-disk fake of ``tests/fake_nuscenes.py``.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from fbbev_tpu.data import transforms as JT
from fbbev_tpu_torch.data import transforms as PT
from tests.fake_nuscenes import write_fake_nuscenes

DATA_CONFIG = dict(input_size=(64, 176), resize=(-0.06, 0.11),
                   crop_h=(0.0, 0.0), flip=True, rot=(-5.4, 5.4),
                   resize_test=0.0)
BDA_CONF = dict(rot_lim=(-22.5, 22.5), scale_lim=(0.95, 1.05),
                flip_dx_ratio=0.5, flip_dy_ratio=0.5)


def assert_same(a, b, what=""):
    """Equal nested results: arrays exactly (dtype and shape included),
    dicts key by key, sequences item by item, scalars with ==."""
    if isinstance(a, dict):
        assert set(a) == set(b), (what, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (
            what, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


@pytest.fixture(scope="module")
def fake():
    """The on-disk fake nuScenes: 2 scenes of 3 frames, 2 cameras (about
    1 MB), in a temporary directory deleted after the module."""
    with tempfile.TemporaryDirectory() as root:
        yield write_fake_nuscenes(root, n_scenes=2, frames_per_scene=3)


# ---------------------------------------------------------------- transforms
def test_quat_to_rot_matches_jax():
    from fbbev_tpu.geometry import quat_to_rot as jq
    from fbbev_tpu_torch.geometry import quat_to_rot as pq
    rng = np.random.RandomState(0)
    for _ in range(5):
        q = rng.randn(4)
        assert_same(pq(q), jq(q))


@pytest.mark.parametrize("is_train", [True, False])
def test_image_and_bda_augmentation_match_jax(is_train):
    """The sampled augmentations, the post homography, the BDA matrix and
    the boxes under BDA, from the same seeded RandomState."""
    rj, rp = np.random.RandomState(3), np.random.RandomState(3)
    boxes = np.random.RandomState(4).randn(5, 9).astype(np.float32)
    for flip in (None, True):
        aj = JT.sample_image_augmentation(DATA_CONFIG, 900, 1600, is_train,
                                          rj, flip=flip)
        ap = PT.sample_image_augmentation(DATA_CONFIG, 900, 1600, is_train,
                                          rp, flip=flip)
        assert_same(ap, aj, "image aug")
        resize, _, crop, fl, rot = aj
        args = (np.eye(2, dtype=np.float32), np.zeros(2, np.float32),
                resize, crop, fl, rot)
        assert_same(PT.update_post_homography(*args),
                    JT.update_post_homography(*args), "post homography")
        tta = dict(flip_dx=True, flip_dy=False)
        bj = JT.sample_bda_augmentation(BDA_CONF, is_train, rj, tta)
        bp = PT.sample_bda_augmentation(BDA_CONF, is_train, rp, tta)
        assert_same(bp, bj, "bda aug")
        assert_same(PT.bda_matrix(*bj), JT.bda_matrix(*bj), "bda")
        assert_same(PT.transform_boxes_bda(boxes, *bj),
                    JT.transform_boxes_bda(boxes, *bj), "boxes")


def test_occupancy_gt_and_depth_map_match_jax():
    """Axis conversions, the training / eval GT (rotated by PIL, flipped),
    the z-buffered depth rasterisation and image normalisation."""
    rng = np.random.RandomState(5)
    occ = rng.randint(0, 18, (20, 20, 6)).astype(np.int32)
    vis = rng.rand(20, 20, 6) < 0.7
    assert_same(PT.occupancy_to_bevdet_axes(occ),
                JT.occupancy_to_bevdet_axes(occ))
    assert_same(PT.occupancy_from_bevdet_axes(occ),
                JT.occupancy_from_bevdet_axes(occ))
    for args in ((0.0, False, False, True), (12.5, True, False, True),
                 (-7.0, False, True, False), (0.0, True, True, True)):
        assert_same(PT.prepare_occupancy_gt(occ, vis, *args),
                    JT.prepare_occupancy_gt(occ, vis, *args), str(args))
    pts = np.concatenate([rng.rand(400, 2) * [176, 64],
                          rng.rand(400, 1) * 50], 1)
    for ds in (1, 4):
        assert_same(PT.points_to_depth_map(pts, 64, 176, (2.0, 42.0), ds),
                    JT.points_to_depth_map(pts, 64, 176, (2.0, 42.0), ds))
    img = rng.randint(0, 255, (4, 5, 3)).astype(np.uint8)
    assert_same(PT.normalize_image(img), JT.normalize_image(img))


def test_rt_matrices_match_jax(fake):
    """nuscenes_rt_matrix in every frame mode and sensor2keyego, on the
    infos of the fake dataset."""
    import pickle
    with open(fake["ann_file"], "rb") as f:
        infos = pickle.load(f)["infos"][:2]
    a, b = infos
    modes = ("global", "ego", "lidar", "CAM_FRONT", "CAM_BACK_XYD")
    for src in modes:
        for dst in modes:
            assert_same(PT.nuscenes_rt_matrix(a, b, src, dst),
                        JT.nuscenes_rt_matrix(a, b, src, dst), (src, dst))
    assert_same(PT.sensor2keyego(b, a, "CAM_BACK"),
                JT.sensor2keyego(b, a, "CAM_BACK"))


# ----------------------------------------------------------------- samplers
@pytest.mark.parametrize("bs,world,rank", [(1, 1, 0), (2, 1, 0), (2, 2, 1)])
def test_samplers_match_jax(bs, world, rank):
    """The first 40 batches of the training sampler and every batch of
    the eval sampler, over uneven scenes."""
    from fbbev_tpu.data import sampler as J
    from fbbev_tpu_torch.data import sampler as P
    flags = np.repeat(np.arange(7), [3, 5, 2, 4, 4, 1, 6])
    ij = iter(J.InfiniteGroupStreamSampler(flags, bs, world, rank, seed=4))
    ip = iter(P.InfiniteGroupStreamSampler(flags, bs, world, rank, seed=4))
    for _ in range(40):
        assert next(ip) == next(ij)
    ej = J.EvalGroupStreamSampler(flags, bs, world, rank)
    ep = P.EvalGroupStreamSampler(flags, bs, world, rank)
    assert len(ep) == len(ej)
    assert list(ep) == list(ej)


# ----------------------------------------------------------------- wrappers
class _Cats:
    """A dataset of the CBGS contract (get_cat_ids, flag, CLASSES)."""

    CLASSES = ("car", "truck", "pedestrian", "cone")

    def __init__(self, seed=0, n=40):
        rng = np.random.RandomState(seed)
        self.cats = [sorted(set(rng.randint(0, 4, rng.randint(0, 3))))
                     for _ in range(n)]
        self.flag = np.arange(n, dtype=np.int64) // 4

    def get_cat_ids(self, i):
        return self.cats[i]

    def __getitem__(self, i):
        return {"index": np.int32(i)}

    def __len__(self):
        return len(self.cats)


def test_wrappers_match_jax():
    from fbbev_tpu.data import wrappers as J
    from fbbev_tpu_torch.data import wrappers as P
    base = _Cats()
    for seed in (0, 3):
        cj, cp = J.CBGSDataset(base, seed=seed), P.CBGSDataset(base,
                                                                seed=seed)
        assert cp.sample_indices == cj.sample_indices
        assert_same(cp.flag, cj.flag)
        assert len(cp) == len(cj)
        assert [cp.get_cat_ids(i) for i in range(len(cp))] == \
            [cj.get_cat_ids(i) for i in range(len(cj))]
        assert_same(cp[5], cj[5])
    rj, rp = J.RepeatDataset(base, 3), P.RepeatDataset(base, 3)
    assert len(rp) == len(rj) == 120
    assert_same(rp.flag, rj.flag)
    assert_same([rp[i] for i in (0, 41, 119)], [rj[i] for i in (0, 41, 119)])
    assert rp.get_cat_ids(77) == rj.get_cat_ids(77)


def test_dataset_registry():
    from fbbev_tpu_torch.data import CBGSDataset, NuScenesDataset, \
        RepeatDataset
    from fbbev_tpu_torch.registry import DATASETS, build_from_cfg
    for cls in (NuScenesDataset, CBGSDataset, RepeatDataset):
        assert DATASETS.get(cls.__name__) is cls
    r = build_from_cfg(dict(type="RepeatDataset", times=2), DATASETS,
                       dataset=_Cats())
    assert len(r) == 80


# ----------------------------------------------------------------- nuScenes
def test_sequence_flags_match_jax():
    from fbbev_tpu.data import compute_sequence_flags as jf
    from fbbev_tpu_torch.data import compute_sequence_flags as pf
    infos = [{"prev": [] if t == 0 else ["x"]}
             for n in (7, 3, 10, 1) for t in range(n)]
    for split in (1, 2, 3, "all"):
        assert_same(pf(infos, split), jf(infos, split), str(split))


@pytest.mark.parametrize("split", ["train", "val", "val_tta"])
def test_nuscenes_items_match_jax(fake, split):
    """Every item of the fake dataset, read by both packages with the
    same seed: images, camera parameters, augmentations, depth maps,
    occupancy GT, boxes and the temporal metadata, exactly."""
    from fbbev_tpu.data import NuScenesDataset as J
    from fbbev_tpu_torch.data import NuScenesDataset as P
    kw = dict(ann_file=fake["ann_file"], data_config=DATA_CONFIG,
              bda_aug_conf=BDA_CONF, occupancy_path=fake["occupancy_path"],
              grid_config=dict(depth=(2.0, 42.0, 0.5)),
              is_train=split == "train", load_depth=split == "train",
              cam_names=fake["cam_names"], seed=7, max_boxes=8,
              sequences_split_num=2 if split == "train" else 1)
    dj, dp = J(**kw), P(**kw)
    if split == "val_tta":
        dj.tta_config = dp.tta_config = dict(tta_flip=True, flip_dx=True,
                                             flip_dy=False)
    assert_same(dp.flag, dj.flag)
    for i in range(len(dj)):
        assert dp.get_cat_ids(i) == dj.get_cat_ids(i)
        assert_same(dp[i], dj[i], f"{split} item {i}")


# ------------------------------------------------------------------- loader
def test_prefetch_loader_matches_sync_order():
    """PrefetchLoader's batches equal the synchronous ones, in sampler
    order, with more threads than batches in flight."""
    from fbbev_tpu_torch.data import SyntheticClipDataset, collate
    from fbbev_tpu_torch.data.loader import PrefetchLoader
    ds = SyntheticClipDataset(n_scenes=3, frames_per_scene=3,
                              input_size=(16, 48), num_cams=2,
                              occ_shape=(8, 8, 4))
    idx_batches = [[0, 3], [1, 4], [2, 5], [6, 7], [8, 0]]
    sync = [collate([ds[i] for i in idxs]) for idxs in idx_batches]
    for workers, prefetch in ((3, 1), (8, 2)):
        pre = list(PrefetchLoader(ds, iter(idx_batches),
                                  num_workers=workers, prefetch=prefetch))
        assert_same(pre, sync, f"workers {workers}")
    assert_same(list(PrefetchLoader(ds, iter(idx_batches), num_workers=0)),
                sync)


def test_prefetch_loader_propagates_errors():
    """An exception in a sample's decode reaches the consumer, after the
    batches before it."""
    from fbbev_tpu_torch.data.loader import PrefetchLoader

    class Boom:
        def __getitem__(self, i):
            if i == 2:
                raise RuntimeError("decode failed")
            return {"index": np.int32(i)}

    got = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for b in PrefetchLoader(Boom(), iter([[0], [1], [2], [3]]),
                                num_workers=2, prefetch=1):
            got.append(int(b["index"][0]))
    assert got == [0, 1]


# ------------------------------------------------------------------ metrics
def test_occupancy_metrics_match_jax():
    """MIoUMetric (int64 confusion matrix, with and without the camera
    mask, over several samples), FScoreMetric and the CVPR-frame format,
    on random logits and labels."""
    from fbbev_tpu.evaluation import occ_metrics as JM
    from fbbev_tpu.evaluation import occ_pred_to_cvpr_format as jfmt
    from fbbev_tpu_torch.evaluation import FScoreMetric, MIoUMetric, \
        occ_pred_to_cvpr_format
    rng = np.random.RandomState(8)
    for use_mask in (True, False):
        mj, mp = JM.MIoUMetric(), MIoUMetric()
        fj, fp = JM.FScoreMetric(), FScoreMetric()
        for _ in range(3):
            logits = rng.randn(40, 40, 8, 19).astype(np.float32)
            pred = occ_pred_to_cvpr_format(logits)
            assert_same(pred, jfmt(logits))
            assert_same(occ_pred_to_cvpr_format(logits, False),
                        jfmt(logits, False))
            gt = rng.randint(0, 18, (40, 40, 8))
            gt = np.where(rng.rand(40, 40, 8) < 0.5, 17, gt)
            mask = rng.rand(40, 40, 8) < 0.8 if use_mask else None
            for m in (mj, mp, fj, fp):
                m.add_batch(pred, gt, mask)
        assert mp.hist.dtype == np.int64
        assert_same(mp.hist, mj.hist)
        assert mp.count_miou() == mj.count_miou()
        assert fp.count_fscore() == fj.count_fscore()


# ------------------------------------------------------- logging, profiling
def test_loggers_match_jax(monkeypatch):
    """The CSV file byte for byte; the TensorBoard records byte for byte
    with the wall time fixed; the webhook's request (urlopen replaced:
    no test reaches the network)."""
    import time
    import urllib.request
    from fbbev_tpu.utils import logging_hooks as J
    from fbbev_tpu_torch.utils import logging_hooks as P
    rows = [{"iter": 1, "loss": 2.5, "grad_norm": 3.25},
            {"iter": 2, "loss": 2.125, "grad_norm": 1.0, "note": "x"}]
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    written = []
    with tempfile.TemporaryDirectory() as d:
        for mod in (J, P):
            work = os.path.join(d, mod.__name__)
            csv_log, tb = mod.CsvLogger(work), mod.TensorboardLogger(work)
            for r in rows:
                csv_log(r)
                tb(r)
            written.append([open(f, "rb").read()
                            for f in (csv_log.path, tb.path)])
    assert written[0] == written[1]
    assert P._masked_crc(b"123456789") == J._masked_crc(b"123456789")
    assert P._crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value

    sent = []

    class Resp:
        status = 204

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def urlopen(req, timeout):
        sent.append((req.full_url, req.data, timeout))
        return Resp()

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    for mod in (J, P):
        hook = mod.WebhookLogger("http://hook.invalid/x", every=2)
        assert [hook(r) for r in rows] == [None, 204]
    assert sent[0] == sent[1]

    def fail(req, timeout):
        raise OSError("unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", fail)
    assert P.WebhookLogger("http://hook.invalid/x")(rows[0]) is None


def test_profiling(capsys):
    """``flops_estimate`` counts a matmul's 2*M*N*K operations (as XLA's
    cost analysis does for the JAX package); ``run_time`` times and
    returns the result."""
    from fbbev_tpu_torch.utils import flops_estimate, run_time
    a, b = torch.zeros(64, 32), torch.zeros(32, 16)
    cost = flops_estimate(lambda x, y: x @ y, a, b)
    assert cost["flops"] == 2 * 64 * 32 * 16
    timed = run_time("mm")(lambda x, y: {"out": [x @ y]})
    assert timed(a, b)["out"][0].shape == (64, 16)
    assert "[run_time] mm:" in capsys.readouterr().out
