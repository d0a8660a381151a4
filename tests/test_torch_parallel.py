"""The port's multi-rank training and evaluation (``fbbev_tpu_torch.parallel``)
on the CPU over gloo, against its own one-process step on the global batch
and against the JAX package's mesh pieces.

One module-scoped fixture spawns ONE two-rank gloo group (one for the
whole test run under xdist, see ``runs``): two child
processes run this file as a script, join through a ``file://`` store in
a temporary directory (no TCP port, so xdist workers cannot collide), set
one thread each, import only the port (numpy, torch, ``fbbev_tpu_torch``:
everything JAX is imported inside the tests), run every multi-rank case
and write their results.  A child that has not finished after
``TIMEOUT`` seconds is killed and every test of the file fails.  The
tests compare those results with one-process runs made here.

The steps run a micro FB-OCC (ResNet-10, 32x96 images, 2 cameras, a
20x20x4 grid), in float32 with the configs' optimizer and in float64
(``float64``, ``test_torch_train``'s patch) with its warmup off, so that
the first update moves every parameter by about 2e-4.  Each child runs
the one-process step beside its own and reports the errors.  ``data=2``
holds one sample a rank of a global batch of 2 and is compared with the
one-process step on both samples with the occupancy losses per sample
and meaned (``Trainer(loss_shards=2)``, JAX's ``_occ_losses_sharded``);
``space=2`` holds one camera a rank of a one-sample batch and is
compared with the one-process step on both.

Tolerances:

* float64: the gradient within 1e-10 of its largest magnitude (measured
  5e-14), every parameter, statistic and EMA element within rtol 1e-5,
  atol 1e-6, each metric within 1e-10 relative: the invariant that after
  the one sum over the world every rank holds the one-process step's
  gradient, with float32 rounding out of the way;
* float32: parameters and EMA within rtol 1e-5, atol 1e-6; the BatchNorm
  running statistics (of order 1: the variances start at 1) rtol 1e-5,
  atol 2e-5 (measured 6.7e-6: the global statistics come from a two-pass
  reduction in another order than ``F.batch_norm``'s, and the
  differences grow with depth, as ``test_torch_train`` measures); the
  gradient within 1e-3 of its largest magnitude (measured 2.0e-4:
  behind every batch-statistics BatchNorm of a random-weight model the
  gradient sums nearly cancel); each metric but ``grad_norm`` 1e-4
  relative (``test_torch_train``'s);
* the pooled BEV of ``space=2`` against JAX's ``_pool`` under
  ``use_mesh(make_mesh(data=1, space=2))``: 1e-5 of its largest value;
* the per-shard loss reduction against JAX's: 1e-5 relative;
* evaluation: the confusion matrices equal, element for element.
"""

import atexit
import contextlib
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from fbbev_tpu_torch import parallel
from fbbev_tpu_torch.config import Config
from fbbev_tpu_torch.models import FBOCC
from fbbev_tpu_torch.models.fbocc import init_temporal_state
from fbbev_tpu_torch.train import Trainer, make_optimizer
from fbbev_tpu_torch.train import checkpoints as CK
from fbbev_tpu_torch.train import loop as PL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
GRID = {"x": (-40.0, 40.0, 4.0), "y": (-40.0, 40.0, 4.0),
        "z": (-1.0, 5.4, 1.6), "depth": (2.0, 42.0, 2.0)}
MICRO = dict(grid_config=GRID,
             bevformer_grid_config={k: GRID[k] for k in "xyz"},
             input_size=(32, 96), num_cams=2, history_cat_num=2,
             single_bev_num_channels=32, depth_channels=20,
             backbone_depth=10, img_feat_channels=64, depth_mid_channels=32,
             max_queries_per_cam=128, history_cat_conv_out_channels=64,
             voxel_channels=(8, 16, 32), voxel_out_channels=16)
LAYOUTS = {"data2": (2, 1), "space2": (1, 2)}
# the loop cases: the tiny synthetic config cut to the micro model, on
# two 2-frame scenes; the global batch holds one sample a data index
LOOP_CUT = {**{f"model.{k}": repr(v) for k, v in MICRO.items()},
            "data.input_size": "(32, 96)", "data.occ_shape": "(40, 40, 8)",
            "data.n_scenes": "2", "data.frames_per_scene": "2",
            "log_interval": "1", "checkpoint_interval": "100"}
LOOP_OPTS = {"data2": {"devices": "2", "data.batch_size": "2"},
             "space2": {"space": "2", "data.batch_size": "1"}}


# ---------------------------------------------------------------------------
# Shared by the children and the tests: torch and numpy only.
# ---------------------------------------------------------------------------

def rig(B, N=2, H=32, W=96, f=40.0):
    """N horizontal cameras around the ego at 1.5 m, (B, N, ...) numpy."""
    rots, trans, intr = [], [], []
    for n in range(N):
        th = 2 * np.pi * n / N
        fwd = [np.cos(th), np.sin(th), 0.0]
        right = [np.sin(th), -np.cos(th), 0.0]
        rots.append(np.stack([right, [0.0, 0.0, -1.0], fwd], 1))
        trans.append([0.1 * n + 0.0137, 0.05 * n + 0.0137, 1.5137])
        intr.append([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    rep = (lambda a: np.repeat(np.asarray(a, np.float32)[None], B, 0))
    return dict(rots=rep(rots), trans=rep(trans), intrins=rep(intr),
                post_rots=rep(np.tile(np.eye(3), (N, 1, 1))),
                post_trans=np.zeros((B, N, 3), np.float32),
                bda=rep(np.eye(3)))


def micro_batch(B, seed=0):
    """numpy batch of ``B`` stream starts for the micro model."""
    rng = np.random.RandomState(seed)
    occ = rng.randint(0, 19, size=(B, 40, 40, 8))
    occ = np.where(rng.rand(B, 40, 40, 8) < 0.3, 255, occ)
    depth = rng.rand(B, 2, 32, 96).astype(np.float32) * 45.0
    depth = np.where(rng.rand(B, 2, 32, 96) < 0.8, 0.0, depth)
    return dict(imgs=rng.randn(B, 2, 32, 96, 3).astype(np.float32),
                **rig(B), start_of_sequence=np.ones(B, bool),
                sequence_group_idx=np.arange(B, dtype=np.int32),
                curr_to_prev_ego_rt=np.repeat(np.eye(4, dtype=np.float32)
                                              [None], B, 0),
                gt_occupancy=occ.astype(np.int32),
                gt_depth=depth.astype(np.float32))


def pool_inputs(seed=1):
    """(cam, context (1, 2, 2, 6, 32), depth (1, 2, 20, 2, 6)) numpy."""
    rng = np.random.RandomState(seed)
    d = rng.rand(1, 2, 20, 2, 6).astype(np.float32)
    return (rig(1), rng.randn(1, 2, 2, 6, 32).astype(np.float32),
            d / d.sum(2, keepdims=True))


def loss_inputs(seed=3):
    """Fixed occupancy logits (2, 8, 8, 4, 19) and labels."""
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 8, 8, 4, 19).astype(np.float32),
            rng.randint(0, 19, size=(2, 8, 8, 4)).astype(np.int32))


@contextlib.contextmanager
def float64():
    """The port in float64 (``test_torch_train._float64``'s patch):
    ``Tensor.float`` casts to float64, new floating tensors and float32
    numpy arrays come in as float64."""
    own = torch.Tensor.__dict__.get("float")
    real_from_numpy, old = torch.from_numpy, torch.get_default_dtype()
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.from_numpy = (lambda a: real_from_numpy(a).double()
                        if a.dtype == np.float32 else real_from_numpy(a))
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        if own is None:
            del torch.Tensor.float
        else:
            torch.Tensor.float = own
        torch.from_numpy = real_from_numpy
        torch.set_default_dtype(old)


def micro_trainer(f64=False):
    """(Trainer of the micro model, its initial state, the list its
    optimizer appends each step's gradient to); the same weights in every
    process.  float32: the configs' optimizer (its first step's learning
    rate is 2e-7); float64: warmup off, every parameter moves by ~2e-4."""
    with float64() if f64 else contextlib.nullcontext():
        model = FBOCC(**MICRO, device="cpu",
                      dtype=torch.float64 if f64 else torch.float32,
                      generator=torch.Generator().manual_seed(0))
        tr = Trainer(model, optimizer=make_optimizer(
            warmup_iters=0 if f64 else 200), lovasz="sort")
        seen = []
        real = tr.optimizer.update
        tr.optimizer.update = (lambda g, *a, **k: (seen.append(g.clone()),
                                                   real(g, *a, **k))[1])
        return tr, tr.init_state(), seen


def micro_step(trainer, batch, mesh=None, loss_shards=1, f64=False):
    """One train step of ``micro_trainer(f64)``'s (trainer, initial
    state, gradients) from that state on the numpy ``batch`` under
    ``mesh``: its new state, gradient and metrics as numpy."""
    tr, s0, seen = trainer
    with float64() if f64 else contextlib.nullcontext():
        tr.loss_shards = loss_shards
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        ts = init_temporal_state(b["imgs"].shape[0], (20, 20, 4), 2, 32,
                                 dtype=tr.model.dtype, device="cpu")
        seen.clear()
        with parallel.use_mesh(mesh):
            st, _, m = tr.train_step(s0, ts, b)
    return dict(params=st.params.numpy(), batch_stats=st.batch_stats.numpy(),
                ema_params=st.ema_params.numpy(),
                ema_batch_stats=st.ema_batch_stats.numpy(),
                grads=seen[0].numpy(),
                metrics={k: float(v) for k, v in m.items()})


STATE = ("params", "batch_stats", "ema_params", "ema_batch_stats")


def step_errors(got, want, f64):
    """The figures the step tests hold (a child holds both steps' arrays;
    only these reach the tests), each <= 1 where within its tolerance
    (module docstring): per state tensor and per metric the largest error
    over its tolerance, the gradient's largest error over its largest
    magnitude."""
    g, w = got["grads"], want["grads"]
    out = dict(grad=float(np.abs(g - w).max() / np.abs(w).max()
                          / (1e-10 if f64 else 1e-3)))
    for k in STATE:
        atol = 1e-6 if f64 or "params" in k else 2e-5
        out[k] = float((np.abs(got[k] - want[k])
                        / (atol + 1e-5 * np.abs(want[k]))).max())
    rtol = 1e-10 if f64 else 1e-4
    out["metrics"] = {k: abs(got["metrics"][k] - v) / (1e-6 + rtol * abs(v))
                      for k, v in want["metrics"].items() if k != "grad_norm"}
    return out


def step_digest(got):
    return {k: hashlib.sha256(got[k].tobytes()).hexdigest()
            for k in STATE + ("grads",)}


def loop_cfg_path():
    return os.path.join(ROOT, "fbbev_tpu_torch", "configs",
                        "fbocc-r50-tiny_synthetic.py")


def loop_cfg(**opts):
    c = Config.fromfile(loop_cfg_path())
    c.merge_from_options(dict(LOOP_CUT, **opts))
    return c


def evaluate_hist(fn, *a, **kw):
    """(confusion matrix, results) of ``fn(*a, **kw)``, which runs
    ``loop.evaluate``."""
    hists = []
    real = PL.MIoUMetric.count_miou

    def count(self):
        hists.append(self.hist.copy())
        return real(self)
    PL.MIoUMetric.count_miou = count
    try:
        res = fn(*a, **kw)
    finally:
        PL.MIoUMetric.count_miou = real
    return hists[-1], res


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def child(rank: int, d: str) -> None:
    """One rank of the two-rank group: every multi-rank case."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    parallel.distributed_init_if_needed(
        "cpu", init_method=f"file://{d}/store", rank=rank, world_size=2)
    out = {}
    meshes = {n: parallel.make_mesh(*LAYOUTS[n], device="cpu")
              for n in LAYOUTS}
    for n, m in meshes.items():
        out[f"mesh_{n}"] = dict(ranks=m.ranks, coords=(m.data.index,
                                                       m.space.index))
    m = meshes["data2"]
    x = torch.arange(3.0) + 10 * rank
    with parallel.use_mesh(m):
        out["collectives"] = dict(
            replicated=parallel.replicate({"x": x}, m)["x"].numpy(),
            gathered=parallel.gather_to_host({"x": x}, m)["x"],
            summed=parallel.all_reduce_sum(x, "data").numpy())

    # data=2: this rank's row of the global batch of 2
    trainers = {f64: micro_trainer(f64) for f64 in (False, True)}
    batch = micro_batch(2)
    # each layout's one-process step runs on one rank (data=2's on 0,
    # space=2's on 1); every rank digests what it holds
    for f64, tr in trainers.items():
        got = micro_step(tr, parallel.shard_batch(batch, m), m, f64=f64)
        out[f"digest_data2_{f64}"] = step_digest(got)
        if rank == 0:
            out[f"step_data2_{f64}"] = step_errors(
                got, micro_step(tr, batch, loss_shards=2, f64=f64), f64)
    # the per-shard loss reduction on fixed logits
    logits, gt = loss_inputs()
    tr = Trainer(trainers[False][0].model, lovasz="hist")
    lo = parallel.shard_batch({"occ_logits": logits, "gt_occupancy": gt}, m)
    with parallel.use_mesh(m):
        shares = tr.losses({"occ_logits": torch.from_numpy(lo["occ_logits"])},
                           {"gt_occupancy": torch.from_numpy(
                               lo["gt_occupancy"])})
        out["loss_reduction"] = {
            k: float(parallel.all_reduce_sum(v.detach(), "data"))
            for k, v in shares.items()}

    # space=2: this rank's camera of a one-sample batch
    s = meshes["space2"]
    cam, ctx, dep = pool_inputs()
    local = dict(parallel.split_cameras(cam, s), context=ctx[:, rank:rank + 1],
                 depth=dep[:, rank:rank + 1])
    fp = tr.model.forward_projection
    from fbbev_tpu_torch import geometry
    with parallel.use_mesh(s):
        out["pool_space2"] = fp(
            geometry.CamParams(*(torch.from_numpy(local[k]) for k in
                                 geometry.CamParams._fields)),
            torch.from_numpy(local["context"]),
            torch.from_numpy(local["depth"])).numpy()
    batch = micro_batch(1)
    for f64, tr in trainers.items():
        got = micro_step(tr, parallel.split_cameras(batch, s), s, f64=f64)
        out[f"digest_space2_{f64}"] = step_digest(got)
        if rank == 1:
            out[f"step_space2_{f64}"] = step_errors(
                got, micro_step(tr, batch, f64=f64), f64)

    # the loop: two iterations, rank 0's checkpoint restored on every
    # rank, then evaluate from that checkpoint
    # rank 0's checkpoint restored on every rank, then evaluate from that
    # checkpoint; space=2 through the two tools
    from fbbev_tpu_torch.tools import test as test_tool
    from fbbev_tpu_torch.tools import train as train_tool
    for n, opts in LOOP_OPTS.items():
        wd = os.path.join(d, n)
        cfg = loop_cfg(**opts)
        if n == "space2":
            flags = (["--device", "cpu", "--space", "2", "--work-dir", wd,
                      "--cfg-options"]
                     + [f"{k}={v}" for k, v in LOOP_CUT.items()]
                     + ["data.batch_size=1"])
            r = train_tool.main([loop_cfg_path(), "--max-iters", "2"]
                                + flags)
        else:
            r = PL.train(cfg, max_iters=2, work_dir=wd, device="cpu")
        restored = CK.restore_checkpoint(os.path.join(wd, "ckpts"),
                                         r["trainer"].init_state())
        same = all(torch.equal(a, b) for a, b in zip(
            CK.state_to_dict(r["state"]).values(),
            CK.state_to_dict(restored).values())
            if isinstance(a, torch.Tensor))
        if n == "space2":
            hist, res = evaluate_hist(test_tool.main, [loop_cfg_path()]
                                      + flags)
        else:
            hist, res = evaluate_hist(PL.evaluate, cfg, device="cpu",
                                      work_dir=wd)
        out[f"loop_{n}"] = dict(
            same=same, step=int(restored.step), digest=digest(
                restored.params), digest_ema=digest(restored.ema_params),
            digest_stats=digest(restored.batch_stats),
            history=[h["iter"] for h in r["history"]],
            ckpts=sorted(os.listdir(os.path.join(wd, "ckpts"))),
            hist=hist, n_samples=res["n_samples"])
    dist.barrier()
    dist.destroy_process_group()
    # the one-process evaluation of one layout's checkpoint, a rank each
    n = sorted(LOOP_OPTS)[rank]
    out[f"one_process_{n}"] = evaluate_hist(
        PL.evaluate, loop_cfg(**{k: v for k, v in LOOP_OPTS[n].items()
                                 if k not in ("devices", "space")}),
        device="cpu", work_dir=os.path.join(d, n))
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# The fixture and the tests.
# ---------------------------------------------------------------------------

def jax_references():
    """The JAX package's side, made while the children run: the device
    array of each layout's ``make_mesh``, ``Trainer._occ_losses_sharded``
    under a two-device ``data`` mesh on the children's fixed logits, and
    ``LSSViewTransformer3D._pool`` under ``use_mesh(make_mesh(data=1,
    space=2))`` on their pool inputs."""
    import jax
    import jax.numpy as jnp
    from fbbev_tpu import geometry as jgeo
    from fbbev_tpu.models.losses import bev_distance_weight
    from fbbev_tpu.models.lss import LSSViewTransformer3D
    from fbbev_tpu.parallel import make_mesh, use_mesh
    from fbbev_tpu.train.trainer import Trainer as JaxTrainer
    two = jax.devices()[:2]
    out = {n: np.vectorize(lambda dv: dv.id)(make_mesh(
        data=data, space=space, devices=two).devices)
        for n, (data, space) in LAYOUTS.items()}
    # jitted, as the JAX train step runs them: eager shard_map runs op by
    # op, 10-20x slower on the CPU
    logits, gt = loss_inputs()
    with use_mesh(make_mesh(data=2, devices=two)):
        out["loss_reduction"] = {
            k: float(v) for k, v in jax.jit(
                JaxTrainer(model=None)._occ_losses_sharded)(
                jnp.asarray(logits), jnp.asarray(gt),
                jnp.asarray(bev_distance_weight(8, 8))).items()}
    cam, ctx, dep = pool_inputs()
    lss = LSSViewTransformer3D(GRID, (32, 96), 16)
    coor = jgeo.frustum_to_ego(jnp.asarray(lss.frustum), jgeo.CamParams(
        **{k: jnp.asarray(v) for k, v in cam.items()}))
    with use_mesh(make_mesh(data=1, space=2, devices=two)):
        out["pool"] = np.asarray(jax.jit(lss._pool)(
            coor, jnp.asarray(dep), jnp.asarray(ctx)))
    return out


def run_group():
    """Spawn the two-rank group in a temporary directory, make
    :func:`jax_references` meanwhile, wait at most ``TIMEOUT`` s (then
    kill the children and fail): (both ranks' results {rank: dict},
    the JAX references)."""
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        logs = [open(os.path.join(d, f"log{r}.txt"), "w") for r in (0, 1)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), d],
            cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in (0, 1)]
        t0 = time.monotonic()
        try:
            refs = jax_references()
            for p in procs:
                p.wait(timeout=max(1.0, TIMEOUT - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        rcs = [p.returncode for p in procs]
        if rcs != [0, 0]:
            tails = [open(os.path.join(d, f"log{r}.txt")).read()[-3000:]
                     for r in (0, 1)]
            pytest.fail(f"two-rank group failed (exit codes {rcs}, "
                        f"{TIMEOUT} s limit):\n" + "\n----\n".join(tails))
        return {r: torch.load(os.path.join(d, f"rank{r}.pt"),
                              weights_only=False) for r in (0, 1)}, refs


@pytest.fixture(scope="module")
def runs():
    """:func:`run_group`'s results.  Under xdist the tests of this file
    may land on several workers: the first to get here runs the group and
    leaves its (small) results in a directory named after the test run
    (``PYTEST_XDIST_TESTRUNUID``), removed when that worker exits; the
    others wait for them (or, the directory gone, run their own)."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return run_group()
    shared = os.path.join(tempfile.gettempdir(),
                          f"fbbev_torch_parallel_{uid}")
    done = os.path.join(shared, "results.pt")
    try:
        os.mkdir(shared)
    except FileExistsError:
        t0 = time.monotonic()
        while os.path.isdir(shared) and time.monotonic() - t0 < TIMEOUT + 60:
            if os.path.exists(done):
                return torch.load(done, weights_only=False)
            if os.path.exists(os.path.join(shared, "failed")):
                pytest.fail("the two-rank group failed on another worker")
            time.sleep(0.2)
        return run_group()
    atexit.register(shutil.rmtree, shared, True)
    try:
        res = run_group()
    except BaseException:
        open(os.path.join(shared, "failed"), "w").close()
        raise
    torch.save(res, done + ".tmp")
    os.replace(done + ".tmp", done)
    return res


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_rank_order_as_jax(runs, layout):
    """Rank r sits at (r // space, r % space): the place of device r in
    the JAX ``make_mesh`` device array of the same layout."""
    res, refs = runs
    ids, space = refs[layout], LAYOUTS[layout][1]
    for r in (0, 1):
        got = res[r][f"mesh_{layout}"]
        np.testing.assert_array_equal(got["ranks"], ids)
        assert tuple(np.argwhere(ids == r)[0]) == got["coords"]
        assert divmod(r, space) == got["coords"]


def test_collectives(runs):
    """``replicate`` is rank 0's value everywhere, ``gather_to_host``
    every rank's in rank order, ``all_reduce_sum`` their sum."""
    res, _ = runs
    x = [np.arange(3.0) + 10 * r for r in (0, 1)]
    for r in (0, 1):
        c = res[r]["collectives"]
        np.testing.assert_array_equal(c["replicated"], x[0])
        np.testing.assert_array_equal(c["gathered"], np.concatenate(x))
        np.testing.assert_array_equal(c["summed"], x[0] + x[1])


def _check_step(got):
    for k in ("grad",) + STATE:
        assert got[k] <= 1.0, (k, got[k])
    for k, v in got["metrics"].items():
        assert v <= 1.0, (k, v)


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
def test_data_parallel_step_matches_global_batch(runs, f64):
    """``data=2``: after one step both ranks hold the same parameters,
    statistics, EMA and gradient, and those, with the metrics, of the
    one-process step on the global batch with per-shard losses
    (``Trainer(loss_shards=2)``, run by rank 0)."""
    res, _ = runs
    _check_step(res[0][f"step_data2_{f64}"])
    assert res[0][f"digest_data2_{f64}"] == res[1][f"digest_data2_{f64}"]


def test_sharded_loss_reduction_matches_jax(runs):
    """The occupancy losses of each rank's batch row, reduced over
    ``data``, against JAX's ``Trainer._occ_losses_sharded`` under a
    two-device mesh on the same logits."""
    res, refs = runs
    want = refs["loss_reduction"]
    for r in (0, 1):
        got = res[r]["loss_reduction"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)


def test_space_pool_matches_jax(runs):
    """``space=2``: each rank pools its camera and the partial BEVs add
    over ``space``, JAX's ``LSSViewTransformer3D._pool`` under
    ``use_mesh(make_mesh(data=1, space=2))``."""
    res, refs = runs
    want = refs["pool"]
    assert np.abs(want).max() > 0
    for r in (0, 1):
        got = res[r]["pool_space2"]
        assert got.shape == want.shape == (1, 20, 20, 4, 32)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
def test_space_step_matches_one_process(runs, f64):
    """``space=2``: one camera a rank; after one step both ranks hold the
    same gradient, parameters, statistics and EMA, those of the
    one-process step on both cameras (the image stage's gradient summed
    over ``space``, the replicated BEV stages' counted once)."""
    res, _ = runs
    _check_step(res[1][f"step_space2_{f64}"])
    assert res[0][f"digest_space2_{f64}"] == res[1][f"digest_space2_{f64}"]


@pytest.mark.parametrize("layout", sorted(LOOP_OPTS))
def test_evaluate_matches_one_process(runs, layout):
    """``evaluate`` on two ranks (``space=2``: ``tools/test.py --space
    2``), from rank 0's checkpoint: the confusion matrix and
    ``n_samples`` of the one-process evaluation of the same checkpoint
    over the same global batch (a child runs it after the group)."""
    res, _ = runs
    want, wres = [res[r][f"one_process_{layout}"] for r in (0, 1)
                  if f"one_process_{layout}" in res[r]][0]
    assert want.sum() > 0
    for r in (0, 1):
        got = res[r][f"loop_{layout}"]
        np.testing.assert_array_equal(got["hist"], want)
        assert got["n_samples"] == wres["n_samples"] == 4


@pytest.mark.parametrize("layout", sorted(LOOP_OPTS))
def test_loop_checkpoint_restored_on_every_rank(runs, layout):
    """Two iterations of ``train`` (``space=2``: ``tools/train.py --space
    2``): one checkpoint (rank 0's), which every rank restores to the
    state it holds; both ranks hold the same one."""
    res, _ = runs
    a, b = res[0][f"loop_{layout}"], res[1][f"loop_{layout}"]
    for got in (a, b):
        assert got["same"] and got["step"] == 2
        assert got["history"] == [1, 2]
        assert got["ckpts"] == ["2.pt"]
    for k in ("digest", "digest_ema", "digest_stats"):
        assert a[k] == b[k], k


if __name__ == "__main__":
    child(int(sys.argv[1]), sys.argv[2])
