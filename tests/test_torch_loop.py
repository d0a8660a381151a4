"""The port's training and evaluation loop -- checkpoints, warm start,
``train``, ``evaluate`` and the two tools -- against the JAX package's,
on the CPU in float32.

The loop runs the tiny synthetic config cut further (``CUT``: a
ResNet-10, 64-channel image features and depth net, batch 1), so that a
checkpoint is about 100 MB and the JAX train step compiles in well under
a minute.  Both loops warm-start from one ``.npz`` of numpy-seeded JAX
variables through ``load_from``; the JAX ``Trainer.init_state`` is
replaced by zeros of the same shapes for that run (every leaf is then
overwritten by the warm start, which the log's ``missing_in_ckpt: 0``
shows), saving its minute-long ``init`` compile.  Both use the sort
Lovasz (the hist form materialises a (classes, voxels, 2048) one-hot on
the JAX side).  Every file the tests write lives in a temporary
directory that is deleted when the test ends.

Tolerances (measured on one CPU host: first-iteration losses 1.8e-5 at
most, later ones 2.1e-5, ``grad_norm`` 0.44%, confusion matrices equal):

* first iteration, each loss: 1e-4 relative (``test_torch_train``'s);
* later iterations, each loss: 1e-3 relative -- the two states drift
  apart as the gradients do;
* ``grad_norm``, every iteration: 2e-2 relative.  Behind the
  batch-statistics BatchNorms of a random-weight model the gradient sums
  nearly cancel (``test_torch_train`` anchors it to float64 for that
  reason);
* evaluation on the same weights: the confusion matrices differ on at
  most 0.1% of the voxels (logits near an argmax tie may flip with f32
  summation order).
"""

import contextlib
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.config import Config as JaxConfig
from fbbev_tpu.train import loop as JL
from fbbev_tpu.train import trainer as JT
from fbbev_tpu_torch.config import Config
from fbbev_tpu_torch.train import checkpoints as CK
from fbbev_tpu_torch.train import loop as PL
from tests.fake_nuscenes import write_fake_nuscenes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "fbocc-r50-tiny_synthetic.py"
CUT = {"model.backbone_depth": "10", "model.depth_mid_channels": "64",
       "model.img_feat_channels": "64", "data.batch_size": "1",
       "log_interval": "1", "checkpoint_interval": "100"}


def port_cfg(name=TINY, **opts):
    c = Config.fromfile(os.path.join(ROOT, "fbbev_tpu_torch", "configs",
                                     name))
    c.merge_from_options(dict(CUT, **opts))
    return c


def jax_cfg(**opts):
    c = JaxConfig.fromfile(os.path.join(ROOT, "fbbev_tpu", "configs", TINY))
    c.merge_from_options(dict(CUT, **opts))
    return c


def fill(rng):
    """numpy-seeded values for a JAX variable of ``path`` and ``shape``
    (``test_torch_slice.jax_variables``'s rule)."""
    def f(path, s):
        names = [getattr(p, "key", None) for p in path]
        shape, name = s.shape, names[-1]
        if names[0] == "batch_stats":
            v = (rng.rand(*shape) * 0.5 + 0.5 if name == "var"
                 else rng.randn(*shape) * 0.1)
        elif name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = rng.rand(*shape) * 0.5 + 0.75
        elif name == "bias":
            v = rng.randn(*shape) * (2.0 if "sampling_offsets" in names
                                     else 0.1)
        else:  # embeddings
            v = rng.randn(*shape)
        return np.asarray(v, np.float32)
    return f


def variable_shapes(cfg):
    """eval_shape of the JAX model's init on the config's first sample."""
    from fbbev_tpu.data import collate
    from fbbev_tpu.models.fbocc import init_temporal_state
    model = JL.build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in
             collate([JL.build_dataset(cfg)[0]]).items()}
    ts = init_temporal_state(1, JL._grid_size(model), model.history_cat_num,
                             model.single_bev_num_channels)
    return dict(jax.eval_shape(model.init, jax.random.PRNGKey(0), batch, ts))


@contextlib.contextmanager
def jax_init_from_shapes(shapes):
    """JAX ``Trainer.init_state`` as zeros of ``shapes`` (what a warm
    start overwrites) instead of a compiled ``init``."""
    def init_state(self, rng, batch, temporal_state):
        p, bs = (jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                              shapes[k]) for k in ("params", "batch_stats"))
        return JT.TrainState(
            step=jnp.zeros((), jnp.int32), params=p, batch_stats=bs,
            opt_state=self.optimizer.init(p),
            ema_params=jax.tree.map(jnp.copy, p),
            ema_batch_stats=jax.tree.map(jnp.copy, bs),
            ema_updates=jnp.asarray(self.ema_init_updates, jnp.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT.Trainer, "init_state", init_state)
        mp.setenv("FBBEV_LOVASZ", "sort")
        yield


class SortLovasz(PL.Trainer):
    """The port's Trainer with the exact (sort) Lovasz, as
    ``FBBEV_LOVASZ=sort`` gives the JAX side."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, lovasz="sort", **kwargs)


def record_batches(mp, trainer_cls, out, to_numpy):
    """Record every batch (as numpy) and do_history of train_step."""
    real = trainer_cls.train_step

    def step(self, state, tstate, batch, do_history=True):
        out.append(({k: to_numpy(v) for k, v in batch.items()},
                    do_history))
        return real(self, state, tstate, batch, do_history=do_history)
    mp.setattr(trainer_cls, "train_step", step)


class Hists:
    """Records every MIoUMetric a loop module creates."""

    def __init__(self, mp, module):
        self.metrics = []
        base = module.MIoUMetric
        outer = self

        class Recorded(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                outer.metrics.append(self)
        mp.setattr(module, "MIoUMetric", Recorded)


def test_train_and_evaluate_match_jax():
    """Both loops from one warm start: 3 train iterations each (the
    temporal curriculum on from the first: one JAX compile), then an
    evaluation of 4 samples on the warm-start weights (``train`` with
    ``max_iters=0`` gives the warm-started state).  One test, so that the
    JAX compiles happen once under any test distribution.

    * the batches fed to the two train steps are equal (sampler, dataset,
      collation), and so is ``do_history``;
    * the logged losses of every iteration and ``grad_norm`` agree within
      the module docstring's tolerances; the loop's bookkeeping matches;
    * the two confusion matrices (int64) differ on at most 0.1% of the
      voxels; the sample count and the result's keys are the same.
    """
    from fbbev_tpu.train.pretrained import save_params_npz
    from tests.test_torch_data import assert_same
    jb, pb = [], []
    with tempfile.TemporaryDirectory() as d:
        npz = os.path.join(d, "warm.npz")
        jc = jax_cfg(temporal_start_iter="0", load_from=npz)
        shapes = variable_shapes(jc)
        save_params_npz(npz, jax.tree_util.tree_map_with_path(
            fill(np.random.RandomState(0)), shapes))
        pc = port_cfg(temporal_start_iter="0", load_from=npz)
        with pytest.MonkeyPatch.context() as mp, jax_init_from_shapes(shapes):
            mp.setattr(PL, "Trainer", SortLovasz)
            record_batches(mp, JT.Trainer, jb, np.asarray)
            record_batches(mp, PL.Trainer, pb, lambda t: t.numpy())
            jax_hist = JL.train(jc, max_iters=3,
                                work_dir=os.path.join(d, "j"))["history"]
            port_hist = PL.train(pc, max_iters=3,
                                 work_dir=os.path.join(d, "p"),
                                 device="cpu")["history"]
            j0 = JL.train(jc, max_iters=0, work_dir=os.path.join(d, "j0"))
            p0 = PL.train(pc, max_iters=0, work_dir=os.path.join(d, "p0"),
                          device="cpu")
            hj, hp = Hists(mp, JL), Hists(mp, PL)
            je = JL.evaluate(jc, state=j0["state"], trainer=j0["trainer"],
                             max_samples=4)
            pe = PL.evaluate(pc, state=p0["state"], trainer=p0["trainer"],
                             max_samples=4, device="cpu")

    assert len(pb) == len(jb) == 3
    for (bp, hist_p), (bj, hist_j) in zip(pb, jb):
        assert hist_p == hist_j
        assert_same(bp, {k: v.astype(bp[k].dtype) if k in bp else v
                         for k, v in bj.items()})

    assert [h["iter"] for h in port_hist] == [1, 2, 3]
    for i, (p, j) in enumerate(zip(port_hist, jax_hist)):
        assert set(p) == set(j)
        for k in j:
            if not k.startswith("loss"):
                continue
            tol = 1e-4 if i == 0 else 1e-3
            assert abs(p[k] - j[k]) <= tol * abs(j[k]), (i, k, p[k], j[k])
        assert abs(p["grad_norm"] - j["grad_norm"]) <= 2e-2 * j["grad_norm"]
        assert p["seq_mismatch"] == j["seq_mismatch"] == 0

    mj, mp_ = hj.metrics[0].hist, hp.metrics[0].hist
    assert mp_.dtype == np.int64 and mp_.sum() == mj.sum() > 0
    assert np.abs(mp_ - mj).sum() / 2 <= 1e-3 * mj.sum()
    assert pe["n_samples"] == je["n_samples"] == 4
    assert set(pe) == set(je)


# ------------------------------------------------------------- checkpoints
def tiny_state(seed, n=1000, step=7):
    from fbbev_tpu_torch.train.trainer import AdamState, TrainState
    g = torch.Generator().manual_seed(seed)
    t = [torch.randn(n, generator=g) for _ in range(6)]
    return TrainState(step=step, params=t[0], batch_stats=t[1][:10],
                      opt_state=AdamState(step, t[2], t[3]),
                      ema_params=t[4], ema_batch_stats=t[5][:10],
                      ema_updates=float(step) + 0.5)


def assert_states_equal(a, b):
    """Bit for bit: every tensor, step, counts."""
    da, db = CK.state_to_dict(a), CK.state_to_dict(b)
    assert set(da) == set(db)
    for k in da:
        if k == "opt_state":
            assert da[k]["count"] == db[k]["count"]
            for m in ("mu", "nu"):
                assert torch.equal(da[k][m], db[k][m]), m
        elif isinstance(da[k], torch.Tensor):
            assert da[k].dtype == db[k].dtype and torch.equal(da[k], db[k]), k
        else:
            assert da[k] == db[k] and type(da[k]) is type(db[k]), k


def test_checkpoint_round_trip_and_format():
    """The round trip is bit for bit; the file is a plain dict that
    ``torch.load(weights_only=True)`` reads; a state of other shapes is
    refused."""
    s = tiny_state(0)
    with tempfile.TemporaryDirectory() as d:
        path = CK.save_checkpoint(d, s)
        assert os.path.basename(path) == "7.pt"
        assert_states_equal(CK.restore_checkpoint(d, tiny_state(1)), s)
        raw = torch.load(path, weights_only=True)
        assert set(raw) == {"step", "params", "batch_stats", "opt_state",
                            "ema_params", "ema_batch_stats", "ema_updates"}
        assert set(raw["opt_state"]) == {"count", "mu", "nu"}
        with pytest.raises(ValueError, match="params"):
            CK.restore_checkpoint(d, tiny_state(1, n=999))
    with pytest.raises(FileNotFoundError):
        CK.restore_checkpoint(d, s)


def test_latest_step_and_max_to_keep_match_jax():
    """Saving steps 1..5 keeps the newest ``max_to_keep`` in both
    packages (JAX's orbax manager on a small TrainState), and
    ``latest_step`` agrees, None for a missing directory."""
    from fbbev_tpu.train import checkpoints as JC

    def jstate(step):
        z = jnp.full((3,), float(step))
        return JT.TrainState(step=jnp.asarray(step, jnp.int32),
                             params={"w": z}, batch_stats={}, opt_state=(),
                             ema_params={"w": z}, ema_batch_stats={},
                             ema_updates=jnp.zeros((), jnp.float32))
    with tempfile.TemporaryDirectory() as d:
        jd, pd = os.path.join(d, "j"), os.path.join(d, "p")
        assert JC.latest_step(jd) is None and CK.latest_step(pd) is None
        for keep in (3, 1):
            for step in range(1, 6):
                JC.save_checkpoint(jd + str(keep), jstate(step),
                                   max_to_keep=keep)
                CK.save_checkpoint(pd + str(keep), tiny_state(step,
                                                              step=step),
                                   max_to_keep=keep)
                assert CK.latest_step(pd + str(keep)) == JC.latest_step(
                    jd + str(keep)) == step
            kept_j = sorted(int(n) for n in os.listdir(jd + str(keep))
                            if n.isdigit())
            assert CK._steps(pd + str(keep)) == kept_j == list(
                range(6 - keep, 6))
        assert_states_equal(CK.restore_checkpoint(pd + "3", tiny_state(0),
                                                  step=4),
                            tiny_state(4, step=4))


def test_torn_write_leaves_previous_checkpoint(monkeypatch):
    """A save that fails half-way (the disk full, say) leaves the previous
    checkpoint as the latest and readable, and no temporary file; a
    temporary file left by a killed process is ignored."""
    s5, s6 = tiny_state(5, step=5), tiny_state(6, step=6)
    with tempfile.TemporaryDirectory() as d:
        CK.save_checkpoint(d, s5)

        def torn(obj, f):
            f.write(b"PK\x03\x04 half a checkpoint")
            raise OSError(28, "No space left on device")
        monkeypatch.setattr(CK.torch, "save", torn)
        with pytest.raises(OSError):
            CK.save_checkpoint(d, s6)
        monkeypatch.undo()
        assert os.listdir(d) == ["5.pt"]
        with open(os.path.join(d, ".6.pt.killed.tmp"), "wb") as f:
            f.write(b"PK\x03\x04 half a checkpoint")
        assert CK.latest_step(d) == 5
        assert_states_equal(CK.restore_checkpoint(d, s6), s5)


# -------------------------------------------------------------- warm start
def small_setup():
    """JAX variables of ``test_torch_slice``'s small FB-OCC (the ResNet-50
    structure the JAX ``.pth`` exporter knows): a target and a source,
    and the port's trainer and state holding the target."""
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.train import Trainer
    from fbbev_tpu_torch.weights import load_jax_variables
    from tests.test_torch_slice import SMALL, jax_variables
    target, src = jax_variables(0), jax_variables(1)
    trainer = Trainer(load_jax_variables(FBOCC(**SMALL, device="cpu"),
                                         target))
    return target, src, trainer, trainer.init_state()


def jax_warm(target, **kw):
    from fbbev_tpu.train.pretrained import load_pretrained
    js = JT.TrainState(step=0, params=target["params"],
                       batch_stats=target["batch_stats"], opt_state=None,
                       ema_params=target["params"],
                       ema_batch_stats=target["batch_stats"],
                       ema_updates=0.0)
    return load_pretrained(js, log=lambda *a: None, **kw)


def assert_port_state_is(trainer, state, jstate):
    """The port's merged params / statistics (and their EMA copies) equal
    ``weights.py`` applied to the JAX merged variables."""
    from fbbev_tpu_torch.weights import to_state_dict
    want = to_state_dict({"params": jstate.params,
                          "batch_stats": jstate.batch_stats})
    got = dict(trainer.unflatten(state.params))
    got.update(trainer.unflatten(state.batch_stats, "batch_stats"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert torch.equal(state.ema_params, state.params)
    assert torch.equal(state.ema_batch_stats, state.batch_stats)


def test_warm_start_from_jax_npz_matches_jax():
    """From a JAX ``save_params_npz`` file holding part of the model (the
    occupancy head left out, one tensor of another shape, one extra
    leaf, ``revise_keys`` renaming a prefix): the port's merged state
    equals ``weights.py`` of JAX's; ``load_img_from`` loads only
    ``img_backbone.*``; a file of nothing the model has raises."""
    from fbbev_tpu.train.pretrained import save_params_npz
    from fbbev_tpu_torch.train.pretrained import load_pretrained
    target, src, trainer, state = small_setup()
    src = {k: dict(v) for k, v in src.items()}
    del src["params"]["occupancy_head"]
    src["params"]["img_neck"] = dict(src["params"]["img_neck"])
    src["params"]["img_neck"]["fpn0"] = {"kernel": np.zeros((2, 2, 2, 2),
                                                            np.float32)}
    src["params"]["extra"] = {"w": np.ones(3, np.float32)}
    src["params"]["renamed_backbone"] = src["params"].pop("img_backbone")
    revise = [(r"^params/renamed_backbone", "params/img_backbone")]
    with tempfile.TemporaryDirectory() as d:
        npz = os.path.join(d, "src.npz")
        save_params_npz(npz, src)
        for kw in (dict(load_from=npz), dict(load_img_from=npz)):
            js = jax_warm(target, revise_keys=revise, **kw)
            ps = load_pretrained(state, trainer, revise_keys=revise,
                                 log=lambda *a: None, **kw)
            assert_port_state_is(trainer, ps, js)
        ps = load_pretrained(state, trainer, load_img_from=npz,
                             revise_keys=revise, log=lambda *a: None)
        before = trainer.unflatten(state.params)
        for name, v in trainer.unflatten(ps.params).items():
            assert torch.equal(v, before[name]) != name.startswith(
                "img_backbone."), name
        np.savez(npz, **{"params/nothing/w": np.ones(2, np.float32)})
        for warm in (lambda: jax_warm(target, load_from=npz),
                     lambda: load_pretrained(state, trainer, load_from=npz,
                                             log=lambda *a: None)):
            with pytest.raises(ValueError, match="loaded 0"):
                warm()


def test_warm_start_from_jax_exported_pth_matches_jax():
    """From a ``.pth`` written from JAX's ``export_fbocc_checkpoint`` (in a
    ``state_dict`` wrapper, one tensor of another shape): the port's
    merged state equals ``weights.py`` of JAX's, for ``load_from`` and
    ``load_img_from``; a ``module.`` prefix is stripped."""
    from fbbev_tpu.train.checkpoint_convert import export_fbocc_checkpoint
    from fbbev_tpu_torch.train.pretrained import load_pretrained
    target, src, trainer, state = small_setup()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_fbocc_checkpoint(src).items()}
    sd["occupancy_head.occ_pred_conv.3.bias"] = torch.zeros(7)
    with tempfile.TemporaryDirectory() as d:
        pth = os.path.join(d, "src.pth")
        torch.save({"state_dict": sd, "meta": {"epoch": 3}}, pth)
        for kw in (dict(load_from=pth), dict(load_img_from=pth)):
            js = jax_warm(target, **kw)
            ps = load_pretrained(state, trainer, log=lambda *a: None, **kw)
            assert_port_state_is(trainer, ps, js)
        want = load_pretrained(state, trainer, load_from=pth,
                               log=lambda *a: None)
        torch.save({"module." + k: v for k, v in sd.items()}, pth)
        got = load_pretrained(state, trainer, load_from=pth,
                              log=lambda *a: None)
        assert torch.equal(got.params, want.params)


# ------------------------------------------------------------ train, resume
def test_resume_eval_and_sinks(monkeypatch):
    """The port alone: 2 iterations with the curriculum flip at 1, a
    mid-run EMA evaluation and TensorBoard on; then a resumed run to 3
    starts from the saved state bit for bit and takes step 2 only; then
    ``evaluate`` from the checkpoint equals ``evaluate`` on the state."""
    seen = []
    real = PL.Trainer.train_step

    def step(self, state, tstate, batch, do_history=True):
        seen.append((CK.state_to_dict(state), do_history))
        return real(self, state, tstate, batch, do_history=do_history)
    monkeypatch.setattr(PL.Trainer, "train_step", step)
    cfg = port_cfg(temporal_start_iter="1", eval_interval="1",
                   eval_max_samples="1", tensorboard="True")
    with tempfile.TemporaryDirectory() as d:
        first = PL.train(cfg, max_iters=2, work_dir=d, device="cpu")
        assert [h["iter"] for h in first["history"]] == [1, 1, 2]
        assert first["history"][1]["val_n_samples"] == 1
        assert [h for _, h in seen] == [False, True]
        assert CK.latest_step(os.path.join(d, "ckpts")) == 2
        assert os.listdir(os.path.join(d, "tf_logs"))
        with open(os.path.join(d, "train_log.csv")) as f:
            assert len(f.read().strip().splitlines()) == 4  # header + 3
        seen.clear()
        second = PL.train(cfg, max_iters=3, work_dir=d, device="cpu",
                          resume=True)
        assert [h["iter"] for h in second["history"]] == [3]
        assert [h for _, h in seen] == [True]
        assert_states_equal(CK.state_from_dict(seen[0][0]), first["state"])
        assert CK._steps(os.path.join(d, "ckpts")) == [2, 3]
        res = PL.evaluate(cfg, work_dir=d, max_samples=2, device="cpu")
        res2 = PL.evaluate(cfg, state=second["state"],
                           trainer=second["trainer"], max_samples=2,
                           device="cpu")
        assert res == res2 and res["n_samples"] == 2


def test_freeze_and_mesh_configs(monkeypatch):
    """``freeze`` keeps a module's parameters and statistics; a mesh
    (``devices``, ``space``) raises, naming M14."""
    starts = []
    real = PL.Trainer.train_step

    def step(self, state, *a, **k):
        starts.append(state)
        return real(self, state, *a, **k)
    monkeypatch.setattr(PL.Trainer, "train_step", step)
    cfg = port_cfg(freeze="('img_backbone',)")
    with tempfile.TemporaryDirectory() as d:
        r = PL.train(cfg, max_iters=1, work_dir=d, device="cpu")
        t, s0, s1 = r["trainer"], starts[0], r["state"]
        for what in ("params", "batch_stats"):
            before = t.unflatten(getattr(s0, what), what)
            moved = {n: not torch.equal(v, before[n]) for n, v in
                     t.unflatten(getattr(s1, what), what).items()}
            assert not any(m for n, m in moved.items()
                           if n.startswith("img_backbone."))
            assert any(m for n, m in moved.items()
                       if n.startswith("depth_net."))
        for opts in ({"devices": "2"}, {"space": "2"}):
            with pytest.raises(NotImplementedError, match="M14"):
                PL.train(port_cfg(**opts), max_iters=1, work_dir=d,
                         device="cpu")
            with pytest.raises(NotImplementedError, match="M14"):
                PL.evaluate(port_cfg(**opts), work_dir=d, device="cpu")


def test_tta_covers_eight_variants(monkeypatch):
    """TTA on the fake nuScenes: 8 passes, one per camera-flip x BEV-dx x
    BEV-dy variant, each over every sample with a fresh state."""
    passes = []
    real = PL._eval_pass

    def eval_pass(sampler, dataset, *a):
        passes.append(dict(dataset.tta_config))
        return real(sampler, dataset, *a)
    monkeypatch.setattr(PL, "_eval_pass", eval_pass)
    with tempfile.TemporaryDirectory() as d:
        fake = write_fake_nuscenes(d, n_scenes=2, frames_per_scene=2)
        cfg = port_cfg()
        cfg["data"] = dict(
            type="NuScenesDataset", ann_file_train=fake["ann_file"],
            ann_file_val=fake["ann_file"],
            data_config=dict(input_size=(64, 176), resize=(-0.06, 0.11),
                             crop_h=(0.0, 0.0), flip=True,
                             rot=(-5.4, 5.4), resize_test=0.0),
            occupancy_path=fake["occupancy_path"],
            grid_config=dict(depth=(2.0, 42.0, 0.5)),
            cam_names=fake["cam_names"], batch_size=1)
        trainer = PL.Trainer(PL.build_model(cfg, device="cpu"))
        res = PL.evaluate(cfg, state=trainer.init_state(), trainer=trainer,
                          tta=True, device="cpu")
    assert res["n_samples"] == 8 * 4
    assert {tuple(sorted(p.items())) for p in passes} == {
        (("flip_dx", bool(v & 2)), ("flip_dy", bool(v & 1)),
         ("tta_flip", bool(v & 4))) for v in range(8)}


def test_tools_train_and_test(capsys):
    """``tools.train`` then ``tools.test`` on the CPU: the checkpoint,
    the printed and returned results, the CSV row; ``--devices`` raises."""
    from fbbev_tpu_torch.tools import test as test_tool
    from fbbev_tpu_torch.tools import train as train_tool
    config = os.path.join(ROOT, "fbbev_tpu_torch", "configs", TINY)
    opts = ["--cfg-options"] + [f"{k}={v}" for k, v in CUT.items()]
    with tempfile.TemporaryDirectory() as d:
        r = train_tool.main([config, "--work-dir", d, "--max-iters", "2",
                             "--device", "cpu"] + opts)
        assert [h["iter"] for h in r["history"]] == [1, 2]
        assert CK.latest_step(os.path.join(d, "ckpts")) == 2
        out_csv = os.path.join(d, "results.csv")
        res = test_tool.main([config, "--work-dir", d, "--max-samples", "1",
                              "--out-csv", out_csv, "--device", "cpu"]
                             + opts)
        assert res["n_samples"] == 1
        assert f"Overall: {res['Overall']}" in capsys.readouterr().out
        with open(out_csv) as f:
            assert f.readline().strip().split(",") == list(res)
        with pytest.raises(NotImplementedError, match="M14"):
            train_tool.main([config, "--work-dir", d, "--devices", "2",
                             "--device", "cpu"] + opts)
