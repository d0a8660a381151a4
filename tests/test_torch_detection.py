"""The port's FB-BEV detection path against the JAX package's, on the CPU
in float32: box ops (top-K, circle NMS, rotated IoU / NMS, BEV corners),
the CenterPoint head, targets, losses and decode, FRPN, the detection
metric, the tiny detection config as a whole (weights converted by
``weights.py`` and loaded with ``strict=True``), the loop and
``tools.test`` on it, the BatchNorm fold and ``tools.vis_bbox``.

Every input is numpy-seeded and handed to both packages.  Tolerances,
stated per test:

* integer outputs, masks and orders (top-K indices, keep masks, labels,
  ``inds``, target masks): equal;
* elementwise float32 results of the same formula (corners, IoU,
  heatmap targets, regression targets, decoded boxes): 1e-6 to 1e-5,
  as each test says -- transcendental functions (exp, log, atan2,
  sin / cos) may round differently in XLA and PyTorch by an ulp;
* reductions over a heatmap (the losses): 1e-5 relative (sums in
  another order);
* network outputs (``det_preds`` of the head and of the whole model):
  1e-4 of max(1, the largest magnitude), the slice tests' measure.

The JAX tiny detection model is built once per module (``det_slice``):
its eager forward and ``init`` shapes take most of this file's ~40 s.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.models import centerpoint_head as JH
from fbbev_tpu.ops import boxes as JB
from fbbev_tpu.train import loop as JL
from fbbev_tpu.train.trainer import Trainer as JaxTrainer
from fbbev_tpu_torch.models import centerpoint_head as PH
from fbbev_tpu_torch.ops import boxes as PB
from fbbev_tpu_torch.train import loop as PL
from fbbev_tpu_torch.train.trainer import Trainer
from fbbev_tpu_torch.weights import (
    centerpoint_head_rules, frpn_rules, load_jax_variables, to_state_dict)

from tests.test_torch_loop import CUT, fill, jax_cfg, port_cfg, \
    variable_shapes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PC_RANGE = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
DET = {"model.use_occupancy_head": "False",
       "model.use_detection_head": "True"}


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol, what=""):
    """Elementwise within ``tol`` of max(1, the largest magnitude)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (what, err, tol * scale)


def padded_boxes(rng, B=2, M=24):
    """(B, M, 9) boxes and (B, M) labels: every class, boxes off the grid,
    zero-size boxes, labels -1 (padding) -- the cases target assignment
    must drop or keep."""
    boxes = np.zeros((B, M, 9), np.float32)
    labels = np.full((B, M), -1, np.int64)
    for b in range(B):
        n = M - 4
        boxes[b, :n, 0:2] = rng.uniform(-38, 38, (n, 2))
        boxes[b, :n, 2] = rng.uniform(-1, 2, n)
        boxes[b, :n, 3:6] = rng.uniform(0.3, 6.0, (n, 3))
        boxes[b, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        boxes[b, :n, 7:9] = rng.randn(n, 2)
        labels[b, :n] = np.arange(n) % 10
        boxes[b, 0, 0:2] = [55.0, 3.0]            # off the grid in x
        boxes[b, 1, 0:2] = [-2.0, -47.0]          # off the grid in y
        boxes[b, 2, 3:5] = 0.0                    # zero-size
        boxes[b, 3, 4] = 0.0                      # zero width only
        boxes[b, n:n + 2, 0:2] = [4.0, 4.0]       # padding with a box
    return boxes, labels


# ------------------------------------------------------------------- box ops
def test_top_k_2d_matches_jax_with_ties():
    """A map of 5 score levels (ties everywhere, as in a bf16 heatmap) and
    a batched (3, 2, ...) map: values, classes, y and x equal to
    ``jax.lax.top_k``'s, lower flat index first among ties."""
    rng = np.random.RandomState(0)
    tied = (rng.randint(0, 5, (2, 9, 13)) / 4.0).astype(np.float32)
    batched = rng.randn(3, 2, 9, 13).astype(np.float32)
    for scores, k in ((tied, 60), (batched, 40)):
        got = [a.numpy() for a in PB.top_k_2d(t(scores), k)]
        lead = scores.shape[:-3]
        for i in np.ndindex(*lead):
            want = JB.top_k_2d(jnp.asarray(scores[i]), k)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[i], np.asarray(w))


def test_circle_nms_matches_jax_batched():
    """Circle NMS over (B=2, tasks=6, K=100) at once against JAX's per
    (sample, task) scan, with a scalar radius and with a radius per
    candidate: keep masks equal, and some candidates suppressed."""
    rng = np.random.RandomState(1)
    centers = rng.uniform(-20, 20, (2, 6, 100, 2)).astype(np.float32)
    scores = -np.sort(-rng.rand(2, 6, 100), -1).astype(np.float32)
    radii = rng.uniform(1, 5, (2, 6, 100)).astype(np.float32)
    jax_nms = jax.jit(JB.circle_nms)
    for radius in (4.0, radii):
        got = PB.circle_nms(t(centers), t(scores),
                            radius if np.isscalar(radius) else t(radius))
        for i in np.ndindex(2, 6):
            r = radius if np.isscalar(radius) else jnp.asarray(radius[i])
            want = jax_nms(jnp.asarray(centers[i]), jnp.asarray(scores[i]),
                           r)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < got.numel()
    keep = PB.circle_nms(t([[0.0, 0.0], [1.0, 0.0], [10.0, 0.0],
                            [10.5, 0.0]]), t([0.9, 0.8, 0.7, 0.6]), 2.0)
    assert keep.tolist() == [True, False, True, False]


def rotated_boxes(rng, n):
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                     rng.uniform(0.5, 3, n), rng.uniform(0.5, 3, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


def test_rotated_iou_and_nms_match_jax():
    """Pairwise IoU of random rotated boxes (12 x 12 and 7 x 9) within
    1e-5 of JAX's, the keep mask of ``nms_rotated`` equal at three
    thresholds, and JAX's axis-aligned case."""
    rng = np.random.RandomState(2)
    a, b = rotated_boxes(rng, 12), rotated_boxes(rng, 9)
    for x, y in ((a, a), (a[:7], b)):
        got = PB.rotated_iou(t(x), t(y)).numpy()
        want = np.asarray(jax.jit(JB.rotated_iou)(jnp.asarray(x),
                                                  jnp.asarray(y)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(np.diag(PB.rotated_iou(t(a), t(a)).numpy()) - 1).max() \
        < 1e-4
    scores = np.sort(rng.rand(12))[::-1].astype(np.float32)
    scores[-1] = -np.inf
    jax_nms = jax.jit(JB.nms_rotated)
    for thr in (0.05, 0.2, 0.5):
        got = PB.nms_rotated(t(a), t(scores), thr).numpy()
        want = np.asarray(jax_nms(jnp.asarray(a), jnp.asarray(scores), thr))
        np.testing.assert_array_equal(got, want)
    square = np.array([[0.0, 0.0, 2.0, 2.0, 0.0], [0.1, 0.0, 2.0, 2.0, 0.0],
                       [5.0, 5.0, 2.0, 2.0, 1.0],
                       [0.0, 0.0, 2.0, 2.0, np.pi / 2]], np.float32)
    keep = PB.nms_rotated(t(square), t([0.9, 0.8, 0.7, 0.6]), 0.5)
    assert keep.tolist() == [True, False, True, False]


def test_boxes_bev_corners_matches_jax():
    """(N, 9) boxes -> (N, 4, 2) corners within 1e-6 of JAX's; a box at
    the origin with yaw 0 has corners (+-2, +-1)."""
    rng = np.random.RandomState(3)
    boxes, _ = padded_boxes(rng, B=1)
    got = PB.boxes_bev_corners(t(boxes[0])).numpy()
    want = np.asarray(JB.boxes_bev_corners(jnp.asarray(boxes[0])))
    close(got, want, 1e-6)
    c = PB.boxes_bev_corners(t([[0.0, 0, 0, 4, 2, 1, 0, 0, 0]]))[0].numpy()
    assert sorted(c[:, 0].tolist()) == [-2, -2, 2, 2]
    assert sorted(c[:, 1].tolist()) == [-1, -1, 1, 1]


# ---------------------------------------------------------- targets, losses
def test_centerpoint_targets_match_jax():
    """Padded boxes on a 100 x 100 grid: heatmaps within 1e-6, ``inds``
    and ``mask`` equal, ``anno`` within 1e-6 of its largest magnitude
    (log, sin and cos of XLA and PyTorch may differ by an ulp); the
    off-grid, zero-size and padding boxes are in no task's mask, and
    every task has objects."""
    rng = np.random.RandomState(4)
    boxes, labels = padded_boxes(rng)
    args = (PH.NUSCENES_TASKS, PH.NUSCENES_CLASSES, (100, 100), PC_RANGE,
            (0.8, 0.8))
    got = PH.centerpoint_targets(t(boxes), t(labels), *args)
    want = JH.centerpoint_targets(jnp.asarray(boxes), jnp.asarray(labels),
                                  *args)
    assert len(got) == len(want) == 6
    for ti, (g, w) in enumerate(zip(got, want)):
        close(g["heatmap"].numpy(), w["heatmap"], 1e-6, f"heatmap {ti}")
        np.testing.assert_array_equal(g["inds"].numpy(), np.asarray(w["inds"]))
        np.testing.assert_array_equal(g["mask"].numpy(), np.asarray(w["mask"]))
        close(g["anno"].numpy(), w["anno"], 1e-6, f"anno {ti}")
        assert g["mask"].any() and not g["mask"][:, :4].any()
        assert g["heatmap"].max() == 1.0


def test_focal_and_centerpoint_loss_match_jax():
    """``gaussian_focal_loss`` and the 12 ``centerpoint_loss`` terms on
    random head outputs and the targets above: 1e-5 relative."""
    rng = np.random.RandomState(5)
    boxes, labels = padded_boxes(rng)
    args = (PH.NUSCENES_TASKS, PH.NUSCENES_CLASSES, (100, 100), PC_RANGE,
            (0.8, 0.8))
    tg = PH.centerpoint_targets(t(boxes), t(labels), *args)
    tj = JH.centerpoint_targets(jnp.asarray(boxes), jnp.asarray(labels),
                                *args)
    preds = head_outputs(rng, B=2, H=100, W=100)
    got = PH.centerpoint_loss([{k: t(v) for k, v in p.items()}
                               for p in preds], tg)
    want = JH.centerpoint_loss([{k: jnp.asarray(v) for k, v in p.items()}
                                for p in preds], tj)
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    logits = preds[0]["heatmap"]
    np.testing.assert_allclose(
        float(PH.gaussian_focal_loss(t(logits), tg[0]["heatmap"])),
        float(JH.gaussian_focal_loss(jnp.asarray(logits),
                                     tj[0]["heatmap"])), rtol=1e-5)


def head_outputs(rng, B, H, W, bf16_heatmap=False):
    """Random per-task head outputs (numpy, channels-last)."""
    out = []
    for tc in PH.NUSCENES_TASKS:
        p = {name: rng.randn(B, H, W, ch).astype(np.float32)
             for name, ch in PH.REG_HEADS}
        hm = (rng.randn(B, H, W, len(tc)) * 1.5 - 1.0).astype(np.float32)
        if bf16_heatmap:
            hm = torch.from_numpy(hm).bfloat16().float().numpy()
        p["heatmap"] = hm
        out.append(p)
    return out


def jax_decode_batch(preds):
    """JAX's decode of every sample, as its loop's ``_make_decode_fn``."""
    decode = jax.jit(lambda p: JH.centerpoint_decode(
        p, JH.NUSCENES_TASKS, PC_RANGE, (0.8, 0.8)))

    def one(b):
        return decode([{k: jnp.asarray(v[b:b + 1]) for k, v in p.items()}
                       for p in preds])
    outs = [one(b) for b in range(preds[0]["heatmap"].shape[0])]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]


def assert_decode_equal(got, want, box_tol=1e-5):
    """Labels and kept rows (score >= 0) equal, scores within 1e-6,
    boxes of the kept rows within ``box_tol`` of max(1, magnitude)."""
    boxes, scores, labels = (np.asarray(a) for a in got)
    np.testing.assert_array_equal(labels, want[2])
    np.testing.assert_array_equal(scores >= 0, want[1] >= 0)
    np.testing.assert_allclose(scores, want[1], rtol=0, atol=1e-6)
    kept = want[1] >= 0
    close(boxes[kept], want[0][kept], box_tol, "boxes")


@pytest.mark.parametrize("bf16_heatmap", [False, True],
                         ids=["f32", "bf16_ties"])
def test_centerpoint_decode_matches_jax(bf16_heatmap):
    """One batched decode (B=2, all six tasks at once) against JAX's
    per-sample decode on the same head outputs: boxes (2, 600, 9); labels
    and keep equal, scores within 1e-6, kept boxes within 1e-5.  With a
    bf16-rounded heatmap many scores tie, and the stable sort keeps JAX's
    order."""
    rng = np.random.RandomState(6)
    preds = head_outputs(rng, B=2, H=100, W=100, bf16_heatmap=bf16_heatmap)
    got = PH.centerpoint_decode([{k: t(v) for k, v in p.items()}
                                 for p in preds], PH.NUSCENES_TASKS,
                                PC_RANGE, (0.8, 0.8))
    assert tuple(got[0].shape) == (2, 600, 9)
    want = jax_decode_batch(preds)
    assert_decode_equal(got, want)
    n_kept = (want[1] >= 0).sum()
    assert 0 < n_kept < want[1].size


# ------------------------------------------------------------- head, FRPN
def test_center_head_matches_jax_on_its_weights():
    """A lone CenterHead (32 input channels, 20 x 20) on numpy-seeded JAX
    variables converted by ``centerpoint_head_rules``: every output
    within 1e-4, the heatmap's final bias initialised at -2.19."""
    rng = np.random.RandomState(7)
    bev = rng.randn(2, 20, 20, 32).astype(np.float32)
    jm = JH.CenterHead(in_channels=32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), bev)
    v = jax.tree_util.tree_map_with_path(fill(rng), dict(shapes))
    pm = load_jax_variables(
        PH.CenterHead(32).eval(), v,
        lambda b: centerpoint_head_rules(b, "", (), 6))
    assert PH.CenterHead(32).task_heads[3].heatmap[1].bias.item() == \
        pytest.approx(-2.19)
    with torch.no_grad():
        got = pm(t(bev).permute(0, 3, 1, 2))
    want = jm.apply(v, jnp.asarray(bev))
    for ti, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == torch.float32
            close(g[k].numpy(), w[k], 1e-4, f"task{ti} {k}")


def test_frpn_and_mask_loss_match_jax():
    """FRPN on converted JAX weights: logits within 1e-4; the BCE + dice
    mask losses within 1e-5 relative, the BCE also against
    ``BCEWithLogitsLoss(pos_weight=2.13)``; registered in ``HEADS``."""
    from fbbev_tpu.models.frpn import FRPN as JaxFRPN
    from fbbev_tpu.models.frpn import bev_mask_loss as jax_loss
    from fbbev_tpu_torch.models.frpn import FRPN, bev_mask_loss
    from fbbev_tpu_torch.registry import HEADS
    assert HEADS.get("FRPN") is FRPN and HEADS.get("CenterHead") is \
        PH.CenterHead
    rng = np.random.RandomState(8)
    x = rng.randn(2, 20, 20, 32).astype(np.float32)
    jm = JaxFRPN(in_channels=32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map_with_path(fill(rng), dict(shapes))
    pm = load_jax_variables(FRPN(32).eval(), v,
                            lambda b: frpn_rules(b, "", ()))
    with torch.no_grad():
        got = pm(t(x).permute(0, 3, 1, 2))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    assert tuple(got.shape) == (2, 20, 20)
    close(got.numpy(), want, 1e-4)
    gt = rng.rand(2, 20, 20) > 0.5
    lp, lj = bev_mask_loss(t(gt), t(want)), jax_loss(jnp.asarray(gt),
                                                      jnp.asarray(want))
    for k in ("mask_ce_loss", "mask_dice_loss"):
        np.testing.assert_allclose(float(lp[k]), float(lj[k]), rtol=1e-5)
    ref = torch.nn.BCEWithLogitsLoss(pos_weight=torch.tensor([2.13]))(
        t(want).reshape(-1, 1), t(gt.astype(np.float32)).reshape(-1, 1))
    np.testing.assert_allclose(float(lp["mask_ce_loss"]), float(ref),
                               rtol=1e-5)


def test_detection_metric_matches_jax():
    """The port's ``DetectionMetric`` gives JAX's results dict, key for
    key (NaN where JAX has NaN), on 4 samples of noisy predictions of
    padded GT, with and without annotated attributes."""
    from fbbev_tpu.evaluation.det_metrics import DetectionMetric as JM
    from fbbev_tpu_torch.evaluation import DetectionMetric as PM
    rng = np.random.RandomState(9)
    mj, mp = JM(PH.NUSCENES_CLASSES), PM(PH.NUSCENES_CLASSES)
    for s in range(4):
        gt, gl = padded_boxes(rng, B=1)
        gt, gl = gt[0], gl[0]
        pred = gt + rng.randn(*gt.shape).astype(np.float32) * 0.4
        scores = rng.rand(len(gt)).astype(np.float32)
        scores[rng.rand(len(gt)) < 0.2] = -1.0
        labels = np.where(rng.rand(len(gt)) < 0.1, (gl + 1) % 10, gl)
        labels = np.maximum(labels, 0)
        attrs = (None if s % 2 else
                 ["vehicle.moving" if i % 3 else "" for i in range(len(gt))])
        for m in (mj, mp):
            m.add_sample(pred, scores, labels, gt, gl, gt_attrs=attrs)
    rj, rp = mj.compute(), mp.compute()
    assert list(rp) == list(rj)
    for k in rj:
        np.testing.assert_equal(rp[k], rj[k], err_msg=k)
    assert np.isfinite(rp["NDS"]) and np.isfinite(rp["mAP"])


# ------------------------------------------------------- the slice as a whole
class WithBoxes:
    """A dataset with padded box GT added to each sample (the synthetic
    clips have none): every class, a box off the grid, padding rows."""

    def __init__(self, ds):
        self.ds, self.flag = ds, ds.flag

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        s = self.ds[i]
        boxes, labels = padded_boxes(np.random.RandomState(100 + i), B=1,
                                     M=16)
        s["gt_boxes"], s["gt_labels"] = boxes[0], labels[0]
        return s


@pytest.fixture(scope="module")
def det_slice():
    """The tiny detection config (cut as ``test_torch_loop``'s) built on
    both sides, numpy-seeded JAX variables loaded into the port with
    ``strict=True``, and two frames of one scene (a start, then history)
    with box GT."""
    from fbbev_tpu.data import collate
    jc, pc = jax_cfg(**DET), port_cfg(**DET)
    jm = JL.build_model(jc)
    v = jax.tree_util.tree_map_with_path(fill(np.random.RandomState(11)),
                                         variable_shapes(jc))
    assert "pts_bbox_head" in v["params"]
    pm = load_jax_variables(PL.build_model(pc, device="cpu"), v)
    ds = WithBoxes(JL.build_dataset(jc, "val"))
    frames = [collate([ds[i]]) for i in (0, 1)]
    assert frames[0]["start_of_sequence"][0] and \
        not frames[1]["start_of_sequence"][0]
    return jc, pc, jm, v, pm, frames


def run_both(det_slice, monkeypatch):
    """The two frames through both eval forwards (the JAX side jitted, its
    fused history warp in the Pallas interpreter, as the port's eval
    forward fuses on K1): [(jax outputs, port outputs)] per frame."""
    import functools
    from fbbev_tpu.models.fbocc import init_temporal_state as jax_state
    from fbbev_tpu_torch.models.fbocc import init_temporal_state
    monkeypatch.setenv("FBBEV_FORCE_FUSE_WARP", "interpret")
    jc, pc, jm, v, pm, frames = det_slice
    grid = PL._grid_size(pm)
    js = jax_state(1, grid, pm.history_cat_num, pm.single_bev_num_channels)
    ts = init_temporal_state(1, grid, pm.history_cat_num,
                             pm.single_bev_num_channels, device="cpu")
    fwd = jax.jit(functools.partial(jm.apply, train=False))
    out = []
    for f in frames:
        jo, js = fwd(v, {k: jnp.asarray(x) for k, x in f.items()}, js)
        with torch.no_grad():
            po, ts = pm({k: t(x) for k, x in f.items()}, ts, train=False)
        out.append((jo, po))
    return out


def test_detection_slice_matches_jax(det_slice, monkeypatch):
    """The tiny detection model on converted JAX weights (no JAX leaf
    without a rule; ``strict=True``), two frames with history:

    * ``det_preds`` (6 tasks x 6 maps, 25 x 25) within 1e-4; no
      ``occ_logits``;
    * ``Trainer.losses`` on each frame's outputs and box GT -- the 12
      detection terms and the depth loss -- within 1e-4 relative;
    * the decode of the port's outputs equals JAX's of its own: labels
      and keep equal, scores within 1e-5, kept boxes within 1e-4 (the
      outputs' tolerance, carried through exp and atan2)."""
    jc, pc, jm, v, pm, frames = det_slice
    sd = to_state_dict(v)
    assert set(sd) == {k for k in pm.state_dict()
                       if not k.endswith("num_batches_tracked")}
    assert sum(k.startswith("pts_bbox_head.") for k in sd) == 37 * 6 + 36 * 2
    trainer, jax_losses = Trainer(pm), jax.jit(JaxTrainer(jm)._losses)
    jax_decode = JL._make_decode_fn(jm)
    for i, ((jo, po), f) in enumerate(zip(run_both(det_slice, monkeypatch),
                                          frames)):
        assert "occ_logits" not in po and len(po["det_preds"]) == 6
        for ti, (g, w) in enumerate(zip(po["det_preds"], jo["det_preds"])):
            assert g["heatmap"].shape == (1, 25, 25,
                                          len(PH.NUSCENES_TASKS[ti]))
            for k in w:
                close(g[k].numpy(), w[k], 1e-4, f"frame {i} task{ti} {k}")
        lp = trainer.losses(po, {k: t(x) for k, x in f.items()})
        lj = jax_losses(jo, {k: jnp.asarray(x) for k, x in f.items()})
        assert sorted(lp) == sorted(lj) and len(lp) == 13
        for k in lj:
            np.testing.assert_allclose(float(lp[k]), float(lj[k]),
                                       rtol=1e-4, err_msg=f"{i} {k}")
        got = PL._make_decode_fn(pm)(po["det_preds"])
        want = [np.asarray(a) for a in jax_decode(jo["det_preds"])]
        boxes, scores, labels = (a.numpy() for a in got)
        np.testing.assert_array_equal(labels, want[2])
        np.testing.assert_array_equal(scores >= 0, want[1] >= 0)
        np.testing.assert_allclose(scores, want[1], rtol=0, atol=1e-5)
        kept = want[1] >= 0
        close(boxes[kept], want[0][kept], 1e-4, "boxes")


def test_fold_detection_model_folds_the_head(det_slice, monkeypatch):
    """The BatchNorm fold of the detection model folds the JAX fold's
    pairs, the head's 37 among them (their convs' biases scaled), and
    keeps ``det_preds`` of the start frame within 1e-4."""
    import copy
    from fbbev_tpu_torch.utils.fuse_bn import fold_batch_norms
    from tests.test_torch_fold import _jax_conv_bn_subtrees
    jc, pc, jm, v, pm, frames = det_slice
    folded = copy.deepcopy(pm)
    pairs = fold_batch_norms(folded)
    head = [c for c, _ in pairs if c.startswith("pts_bbox_head.")]
    assert len(head) == 37 == len(_jax_conv_bn_subtrees(
        v["params"]["pts_bbox_head"]))
    assert len(pairs) == len(_jax_conv_bn_subtrees(v["params"]))
    assert not torch.equal(folded.pts_bbox_head.shared_conv.conv.bias,
                           pm.pts_bbox_head.shared_conv.conv.bias)
    from fbbev_tpu_torch.models.fbocc import init_temporal_state
    f = {k: t(x) for k, x in frames[0].items()}
    outs = []
    for m in (pm, folded):
        ts = init_temporal_state(1, PL._grid_size(m), m.history_cat_num,
                                 m.single_bev_num_channels, device="cpu")
        with torch.no_grad():
            outs.append(m(f, ts, train=False)[0]["det_preds"])
    for a, b in zip(*outs):
        for k in a:
            close(b[k].numpy(), a[k].numpy(), 1e-4, k)


def test_train_evaluate_and_tools_test_on_tiny_detection(monkeypatch,
                                                         capsys):
    """On the tiny detection config with box GT: ``train.loop.train`` (2
    iterations) logs finite ``task{0..5}_loss_heatmap`` / ``_loss_bbox``;
    ``evaluate`` of 2 samples on its state returns finite mAP and NDS
    and the TP errors; ``tools.test`` from the checkpoint prints those
    keys and appends them to a CSV."""
    from fbbev_tpu_torch.tools import test as test_tool
    orig = PL.build_dataset
    monkeypatch.setattr(PL, "build_dataset",
                        lambda c, split="train": WithBoxes(orig(c, split)))
    cfg = port_cfg(**DET)
    with tempfile.TemporaryDirectory() as d:
        out = PL.train(cfg, max_iters=2, work_dir=d, device="cpu")
        hist = out["history"]
        assert [h["iter"] for h in hist] == [1, 2]
        for h in hist:
            for ti in range(6):
                for k in (f"task{ti}_loss_heatmap", f"task{ti}_loss_bbox"):
                    assert np.isfinite(h[k]), (k, h[k])
        res = PL.evaluate(cfg, state=out["state"], trainer=out["trainer"],
                          max_samples=2, device="cpu")
        assert res["n_samples"] == 2
        for k in ("mAP", "NDS", "mATE", "mASE", "mAOE", "mAVE", "mAAE"):
            assert np.isfinite(res[k]), (k, res)
        assert "Overall" not in res
        capsys.readouterr()
        csv = os.path.join(d, "results.csv")
        got = test_tool.main([
            os.path.join(ROOT, "fbbev_tpu_torch", "configs",
                         "fbocc-r50-tiny_synthetic.py"),
            "--work-dir", d, "--max-samples", "2", "--device", "cpu",
            "--out-csv", csv, "--cfg-options"]
            + [f"{k}={v}" for k, v in dict(CUT, **DET).items()])
        printed = capsys.readouterr().out
        for k in ("mAP", "NDS", "mATE", "AP_car"):
            assert f"{k}: " in printed and np.isfinite(got[k]), k
        with open(csv) as f:
            assert "NDS" in f.readline()


# ------------------------------------------------------------------ vis_bbox
def test_vis_bbox_renders_an_npz():
    """``tools.vis_bbox`` draws the predictions above the threshold (red)
    and the GT boxes (green) of an .npz into a PNG of 2 * extent *
    px_per_m pixels a side."""
    from PIL import Image
    from fbbev_tpu_torch.tools import vis_bbox
    rng = np.random.RandomState(12)
    boxes = np.zeros((8, 9), np.float32)
    boxes[:, 0:2] = rng.uniform(-15, 15, (8, 2))
    boxes[:, 3:6] = rng.uniform(2, 5, (8, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 8)
    with tempfile.TemporaryDirectory() as d:
        npz, png = os.path.join(d, "dets.npz"), os.path.join(d, "vis.png")
        np.savez(npz, boxes=boxes, scores=np.arange(8) / 7.0,
                 labels=np.arange(8) % 10, gt_boxes=boxes[:3] + 1.0,
                 gt_labels=np.zeros(3, np.int64))
        n = vis_bbox.main([npz, "--out", png, "--extent", "20",
                           "--px-per-m", "4"])
        assert n == 5  # scores 3/7 .. 7/7 pass the default 0.3
        img = np.asarray(Image.open(png))
        assert img.shape == (160, 160, 3)
        assert (img == [255, 80, 80]).all(-1).any()
        assert (img == [0, 255, 0]).all(-1).any()
