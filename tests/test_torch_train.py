"""The port's train step against the JAX package's, on the CPU in float32.

One ``fbbev_tpu_torch.train.Trainer.train_step`` and one JAX
``Trainer.train_step`` run the small FB-OCC of ``test_torch_slice`` with
the same weights (numpy-seeded, converted by ``weights.py``), the same
batch (numpy-seeded images, ignore-heavy occupancy GT, sparse depth GT)
and the same optimizer (warmup off, so the first update moves every
parameter by about the full learning rate).  Both sides use the exact
(sort) Lovasz: the JAX hist form materialises a (classes, voxels, 2048)
one-hot on the CPU, several GB at this size; ``test_torch_losses`` holds
the hist form.  The port runs with K7 on (its plain version here) and
ResNet stage checkpointing, which must leave the BatchNorm statistics as
one forward pass would.

Tolerances.  Training normalises with batch statistics, often over few
samples (16 per channel at ResNet layer4 here, 2 in the depth net's
camera and global-pool BatchNorms), which amplifies float32 rounding far
beyond the eval path's 1e-6; flax moreover takes the variance as
E[x^2] - E[x]^2.  :func:`test_train_forward_float32_error` measures both
packages against a float64 run of the port and bounds them; the
tolerances below are set from those errors:

* each loss term: 1e-4 relative;
* ``grad_norm`` is anchored to float64, not compared between the two
  float32 runs.  The gradient of this random-weight model is
  ill-conditioned: behind every batch-statistics BatchNorm the gradient
  sums over positions nearly cancel, so float32 rounding moves it far
  more than the forward, and by another amount on another host's float32
  arithmetic.  One port train step runs in float64 on the CPU
  (:func:`float64_port_step`, the same weights and batch); both float32
  results must lie within 2e-2 of its ``grad_norm``, and the port no
  further than JAX plus 5e-3.  Measured on one host (float64 / port
  float32 / JAX float32): fresh stream 1644.436 / 1646.492 /
  1668.402 (errors 1.2e-3 and 1.46e-2), continuation 1161.200 /
  1155.342 / 1157.609 (5.0e-3 and 3.1e-3).  Another host measured the
  fresh stream's port at 1653.23 and JAX at 1662.40: JAX's value alone
  moved by 0.36%;
* updated parameters: every element within 2 lr + 1e-6 (Adam's first
  step is about lr * sign(g), so a gradient element near zero may take
  either sign) and at least 90% of all elements within 1e-6, i.e. the
  same gradient sign (measured: 95.5% against JAX; 98.6% between the
  port's two conv formulations).  Against the float64 step the port's
  update agrees on at least as many elements as JAX's, less 1%
  (measured: port 98.2% and 96.4%, JAX 95.0% and 95.4%);
* BatchNorm running statistics: at least 95% of all elements within 1e-5
  absolute plus 1e-5 of the value (measured 97.4%: activation
  differences of 1e-5..1e-4 relative accumulate with depth), and each
  within 2e-3 of its tensor's largest magnitude.  The ASPP projection
  sits behind a BatchNorm over only B*N = 2 samples (the global-pool
  branch), which amplifies a 1e-5 input difference ~150x: its running
  mean measured 1.6e-3 of its largest value.  The biased variance of the
  update is held exactly by :func:`test_batchnorm_train_matches_flax`;
* the EMA: the decay formula exactly (1e-6) on the port's own parameters,
  and against JAX within the parameters' (statistics') tolerance above;
* the new age-ordered temporal state: 1e-3 of each tensor's largest
  magnitude (its newest slot is the current BEV, downstream of the image
  trunk and the depth net).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.models.fbocc import init_temporal_state as jax_init_state
from fbbev_tpu.train.trainer import Trainer as JaxTrainer
from fbbev_tpu.train.trainer import TrainState as JaxTrainState
from fbbev_tpu.train.trainer import make_optimizer as jax_make_optimizer
from fbbev_tpu_torch.models import FBOCC
from fbbev_tpu_torch.models.fbocc import TemporalState, init_temporal_state
from fbbev_tpu_torch.train import Trainer, make_optimizer
from fbbev_tpu_torch.weights import load_jax_variables, to_state_dict

from tests.test_torch_slice import (SMALL, assert_off_voxel_faces, flow,
                                    jax_model, jax_variables, rig)

torch.set_num_threads(1)

LR = 2e-4


def make_batch(seed, start=True, step=0):
    """numpy batch of the small config: (jax dict, torch dict)."""
    rng = np.random.RandomState(seed)
    cam = rig()
    occ = rng.randint(0, 19, size=(1, 40, 40, 16))
    occ = np.where(rng.rand(1, 40, 40, 16) < 0.3, 255, occ)
    depth = rng.rand(1, 2, 64, 128).astype(np.float32) * 45.0
    depth = np.where(rng.rand(1, 2, 64, 128) < 0.9, 0.0, depth)
    b = dict(imgs=rng.randn(1, 2, 64, 128, 3).astype(np.float32), **cam,
             start_of_sequence=np.array([start]),
             sequence_group_idx=np.zeros(1, np.int32),
             curr_to_prev_ego_rt=flow(0 if start else step),
             gt_occupancy=occ.astype(np.int32),
             gt_depth=depth.astype(np.float32))
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})


def jax_state(trainer, v):
    p, bs = v["params"], v["batch_stats"]
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, batch_stats=bs,
        opt_state=trainer.optimizer.init(p),
        ema_params=jax.tree.map(jnp.copy, p),
        ema_batch_stats=jax.tree.map(jnp.copy, bs),
        ema_updates=jnp.zeros((), jnp.float32))


def port_trainer(v, **kw):
    model = load_jax_variables(FBOCC(**SMALL, device="cpu", **kw), v)
    return Trainer(model, optimizer=make_optimizer(warmup_iters=0),
                   lovasz="sort")


def to_torch_state(ts):
    return TemporalState(*(torch.from_numpy(np.asarray(t)) for t in ts))


@pytest.mark.parametrize("shape", [(2, 27), (3, 4, 5, 16)],
                         ids=["two_samples", "channels_last"])
def test_batchnorm_train_matches_flax(shape):
    """The port's train-mode BatchNorm (channel axis last here, as
    ``channels_last_bn``) against flax ``nn.BatchNorm`` (momentum 0.9):
    output and the updated running statistics to 1e-6, the running
    variance updated with the biased batch variance; ``nn.BatchNorm``'s
    own update (unbiased) differs."""
    import flax.linen as fnn
    from fbbev_tpu_torch.models.layers import bn, channels_last_bn
    rng = np.random.RandomState(5)
    C = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.rand(C) + 0.5).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    mean0 = rng.randn(C).astype(np.float32) * 0.1
    var0 = (rng.rand(C) + 0.5).astype(np.float32)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    want, mut = fbn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"])
    m = bn(1, C)
    with torch.no_grad():
        for t, val in ((m.weight, scale), (m.bias, bias),
                       (m.running_mean, mean0), (m.running_var, var0)):
            t.copy_(torch.from_numpy(val))
    m.train()
    got = channels_last_bn(m, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for t, k in ((m.running_mean, "mean"), (m.running_var, "var")):
        np.testing.assert_allclose(t.numpy(), mut["batch_stats"][k],
                                   rtol=1e-6, atol=1e-6)
    ref = torch.nn.BatchNorm1d(C, momentum=0.1)
    with torch.no_grad():
        ref.running_var.copy_(torch.from_numpy(var0))
    ref(torch.from_numpy(x).reshape(-1, C))
    assert not np.allclose(ref.running_var.numpy(),
                           mut["batch_stats"]["var"], rtol=1e-4)


def test_clip_norm_is_accurate_on_long_vectors():
    """The optimizer clips by optax.global_norm's square root of a sum of
    squares, accurate to float32 rounding on a long vector
    (``torch.linalg.vector_norm`` accumulates in order on the CPU and
    came out 0.3% low on this 30M-element one): Adam's first moment after
    one update is 0.1 * 5 * g / ||g|| to 1e-5 of its largest element,
    against float64."""
    gen = torch.Generator().manual_seed(0)
    n = 30_000_000
    g = torch.randn(n, generator=gen) * torch.rand(n, generator=gen) ** 8
    g[:1000] *= 1000.0
    opt = make_optimizer(warmup_iters=0)
    zeros = torch.zeros_like(g)
    _, st = opt.update(g, opt.init(zeros), zeros)
    want = 0.5 * g.double() / g.double().norm()
    assert (st.mu.double() - want).abs().max() <= 1e-5 * want.abs().max()


def test_train_forward_float32_error(setup):
    """The image trunk in train mode (batch statistics), float32 JAX and
    float32 port against the port in float64: both stay within 1e-3 of
    the largest output, and the port is no further from float64 than
    JAX (whose BatchNorm variance E[x^2] - E[x]^2 cancels).  In eval mode
    the two float32 trunks agree to 1e-5."""
    from fbbev_tpu.serving import _run_bound
    v = setup[0]
    imgs = np.random.RandomState(20).randn(2, 64, 128, 3).astype(
        np.float32)

    def jax_trunk(m):
        feats = m.img_backbone(jnp.asarray(imgs), True)
        return feats + [m.img_neck(feats, True)[0]]

    # jitted: one compiled program runs faster than the trunk op by op
    want = jax.jit(lambda v: jax_model().apply(
        v, jax_trunk, method=_run_bound, mutable=["batch_stats"]))(v)[0]
    outs = []
    for dt in (torch.float32, torch.float64):
        m = load_jax_variables(FBOCC(**SMALL, device="cpu"), v).to(dt)
        m.train()
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).to(dt)
        with torch.no_grad():
            c = m.img_backbone(x)
            outs.append([t.permute(0, 2, 3, 1).double().numpy()
                         for t in c + [m.img_neck(c)]])
    for j, p32, p64 in zip(want, *outs):
        scale = np.abs(p64).max()
        err_j = np.abs(np.asarray(j) - p64).max() / scale
        err_p = np.abs(p32 - p64).max() / scale
        assert err_p <= 1e-3 and err_j <= 1e-3, (err_p, err_j)
        assert err_p <= err_j, (err_p, err_j)


@pytest.fixture(scope="module")
def setup():
    """Weights and the two batches: a fresh stream, then a continuation
    frame with ego motion flow(1)."""
    return jax_variables(), [make_batch(20),
                             make_batch(21, start=False, step=1)]


def history_state(seed=22):
    """A buffered age-ordered history of the same stream (ages 0 and 1),
    numpy: the state a continuation frame starts from."""
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 8, 20, 20, 128).astype(np.float32),
            np.array([[0.0, 1.0]], np.float32), np.zeros(1, np.int32),
            np.eye(4, dtype=np.float32)[None]]


def jax_step(v, batch, tstate, do_history):
    """One JAX train step (sort Lovasz, warmup off) from the weights ``v``;
    returns what the tests compare, as numpy in the port's names:
    (params + statistics, temporal state, metrics, EMA)."""
    from fbbev_tpu.models.fbocc import TemporalState as JaxTemporalState
    jt = JaxTrainer(jax_model(), optimizer=jax_make_optimizer(
        warmup_iters=0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FBBEV_LOVASZ", "sort")
        js, jts, jm = jt.train_step(
            jax_state(jt, v), JaxTemporalState(*map(jnp.asarray, tstate)),
            batch, do_history=do_history)
    out = (to_state_dict({"params": js.params,
                          "batch_stats": js.batch_stats}),
           [np.array(t) for t in jts], {k: float(x) for k, x in jm.items()},
           to_state_dict({"params": js.ema_params,
                          "batch_stats": js.ema_batch_stats}))
    del js, jts
    jax.clear_caches()  # the compiled step: memory the port's step reuses
    return out


@contextlib.contextmanager
def _float64():
    """Run the port in float64: ``Tensor.float`` (and so ``Module.float``)
    casts to float64, new floating tensors default to it, and float32
    numpy arrays come in as float64.  The port casts to float32 where the
    JAX package computes in it (losses, float32 islands, BatchNorm); this
    lifts those casts too."""
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


def float64_port_step(v, batch, tstate, do_history):
    """One port train step (K7's plain version, remat, sort Lovasz) in
    float64 from the weights ``v``: (metrics as floats, updated params by
    name as float64 numpy)."""
    with _float64():
        model = load_jax_variables(FBOCC(
            **SMALL, device="cpu", dtype=torch.float64, pallas3x3=True,
            remat=True), v)
        tr = Trainer(model, optimizer=make_optimizer(warmup_iters=0),
                     lovasz="sort")
        b = {k: t.double() if t.is_floating_point() else t
             for k, t in batch.items()}
        ts, _, tm = tr.train_step(tr.init_state(), to_torch_state(tstate),
                                  b, do_history=do_history)
        params = {k: t.numpy() for k, t in tr.unflatten(ts.params).items()}
    return {k: float(x) for k, x in tm.items()}, params


def agreement(got, want, atol=1e-6):
    """Fraction of all elements of the {name: array} ``want`` that ``got``
    matches within ``atol``."""
    n_ok = sum(int((np.abs(np.asarray(got[k], np.float64) - w) <= atol
                    ).sum()) for k, w in want.items())
    return n_ok / sum(w.size for w in want.values())


def rel_close(got, want, rel, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (what, got, want)


def close_stats(got, want, what):
    """BatchNorm statistics within the tolerance of the module docstring."""
    n_ok, n = 0, 0
    for name, g in got.items():
        g, w = g.numpy(), want[name]
        d = np.abs(g - w)
        assert d.max() <= 2e-3 * np.abs(w).max(), (what, name, d.max())
        n_ok += int((d <= 1e-5 + 1e-5 * np.abs(w)).sum())
        n += d.size
    assert n_ok >= 0.95 * n, (what, n_ok / n)


def close_params(got, want, before=None):
    """Parameters within the tolerance of the module docstring."""
    same, moved, total = 0, 0, 0
    for name, g in got.items():
        w = want[name]
        d = np.abs(g.numpy() - w)
        assert d.max() <= 2 * LR + 1e-6, name
        same += int((d <= 1e-6).sum())
        if before is not None:
            moved += int((np.abs(w - before[name]) > 0.5 * LR).sum())
        total += d.size
    assert same >= 0.9 * total, same / total
    assert before is None or moved >= 0.9 * total, moved / total


def check_step(tr, s0, ts, tt, tm, jout, before):
    """Compare the port's (state, temporal state, metrics) with JAX's."""
    want_sd, jt_state, jm, ema_sd = jout
    for k, want in jm.items():
        if k != "grad_norm":  # anchored to float64 by the caller
            rel_close(tm[k], want, 0.0 if k == "seq_mismatch" else 1e-4, k)
    assert set(tm) == set(jm)
    close_params(tr.unflatten(ts.params), want_sd, before)
    close_stats(tr.unflatten(ts.batch_stats, "batch_stats"), want_sd,
                "batch_stats")
    # EMA: the MEGVII decay after one update, on the port's own values
    d = 0.999 * (1.0 - np.exp(-1.0 / 2000.0))
    for ema, old, new in ((ts.ema_params, s0.params, ts.params),
                          (ts.ema_batch_stats, s0.batch_stats,
                           ts.batch_stats)):
        torch.testing.assert_close(ema, old * d + new * (1 - d), rtol=1e-6,
                                   atol=1e-6)
    close_params(tr.unflatten(ts.ema_params), ema_sd)
    close_stats(tr.unflatten(ts.ema_batch_stats, "batch_stats"), ema_sd,
                "ema_batch_stats")
    for got, want in zip(tt, jt_state):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 1e-3 * max(
            np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("i", [0, 1], ids=["fresh_stream", "continuation"])
def test_train_step_matches_jax(setup, i):
    """(b) a step with do_history=False from the empty state; (c) a
    continuation frame with do_history=True from a buffered history of
    the same stream (ego motion flow(1)).  ``grad_norm`` and the update
    against a float64 port step, as the module docstring states."""
    v, batches = setup
    assert_off_voxel_faces(rig())
    tin = (jax_init_state(1, (20, 20, 8), 2, 64) if i == 0
           else history_state())
    jout = jax_step(v, batches[i][0], tin, bool(i))
    tr = port_trainer(v, pallas3x3=True, remat=True)
    s0 = tr.init_state()
    ts, tt, tm = tr.train_step(s0, to_torch_state(tin), batches[i][1],
                               do_history=bool(i))
    check_step(tr, s0, ts, tt, tm, jout, to_state_dict(v))
    m64, p64 = float64_port_step(v, batches[i][1], tin, bool(i))
    g64 = m64["grad_norm"]
    err_p = abs(float(tm["grad_norm"]) - g64) / g64
    err_j = abs(jout[2]["grad_norm"] - g64) / g64
    assert err_p <= 2e-2 and err_j <= 2e-2, (err_p, err_j)
    assert err_p <= err_j + 5e-3, (err_p, err_j)
    same_p = agreement(tr.unflatten(ts.params), p64)
    same_j = agreement(jout[0], p64)
    assert same_p >= 0.9 and same_j >= 0.9, (same_p, same_j)
    assert same_p >= same_j - 1e-2, (same_p, same_j)
    assert int(tm["seq_mismatch"]) == 0
    if i == 1:
        # the continuation really used the buffered history: its fused
        # frames differ from a fresh stream's
        assert float(tt.sweep_time[0, 1]) == 1.0


def test_pallas3x3_step_equals_plain_conv_step(setup):
    """(d) the port's step with K7 routed (plain version on the CPU, its
    custom backward) equals the step with ``nn.Conv2d``: losses to 1e-5
    relative; grad_norm, parameters and BatchNorm statistics to the
    tolerances of the module docstring."""
    v, batches = setup
    res = []
    for k7 in (True, False):
        tr = port_trainer(v, pallas3x3=k7)
        n = sum(isinstance(m, torch.nn.Conv2d) and type(m).__name__
                == "Conv3x3K7" for m in tr.model.modules())
        assert n == (21 if k7 else 0)
        t0 = init_temporal_state(1, (20, 20, 8), 2, 64, device="cpu")
        s, _, m = tr.train_step(tr.init_state(), t0, batches[0][1],
                                do_history=False)
        res.append((s.params, s.batch_stats, m))
        del tr, s
    (a_p, a_bs, ma), (b_p, b_bs, mb) = res
    for k in ma:
        rel_close(ma[k], mb[k], 1e-2 if k == "grad_norm" else 1e-5, k)
    d = (a_p - b_p).abs()
    assert d.max() <= 2 * LR + 1e-6
    assert (d <= 1e-6).float().mean() >= 0.9
    d = (a_bs - b_bs).abs()
    assert d.max() <= 2e-3 * b_bs.abs().max()
    assert (d <= 1e-5 + 1e-5 * b_bs.abs()).float().mean() >= 0.95


def test_eval_step_uses_ema_weights(setup):
    """eval_step runs the eval forward (coarse-pred occ head, K3's plain
    version, running statistics) on the EMA weights: finite logits of the
    GT's shape, and after one step they differ from the live weights'."""
    v, batches = setup
    tr = port_trainer(v)
    t0 = init_temporal_state(1, (20, 20, 8), 2, 64, device="cpu")
    s1, t1, _ = tr.train_step(tr.init_state(), t0, batches[0][1],
                              do_history=False)
    out_ema, _ = tr.eval_step(s1, t1, batches[1][1])
    out_live, _ = tr.eval_step(s1, t1, batches[1][1], use_ema=False)
    lg = out_ema["occ_logits"]
    assert lg.shape == (1, 40, 40, 16, 19) and torch.isfinite(lg).all()
    assert not torch.equal(lg, out_live["occ_logits"])


def test_frozen_module_keeps_params_and_stats(setup):
    """frozen=('img_backbone',): its parameters and BatchNorm statistics
    stay bit-identical while the neck moves (trainer.py:61-89, 221-226)."""
    v, batches = setup
    model = load_jax_variables(FBOCC(**SMALL, device="cpu"), v)
    frozen = ("img_backbone",)
    tr = Trainer(model, optimizer=make_optimizer(frozen=frozen,
                                                 warmup_iters=0),
                 frozen=frozen, lovasz="sort")
    s0 = tr.init_state()
    t0 = init_temporal_state(1, (20, 20, 8), 2, 64, device="cpu")
    s1, _, _ = tr.train_step(s0, t0, batches[0][1], do_history=False)
    for what in ("params", "batch_stats"):
        old = tr.unflatten(getattr(s0, what), what)
        new = tr.unflatten(getattr(s1, what), what)
        for n in old:
            if n.startswith("img_backbone."):
                assert torch.equal(old[n], new[n]), n
    p0, p1 = tr.unflatten(s0.params), tr.unflatten(s1.params)
    assert any(not torch.equal(p0[n], p1[n]) for n in p0
               if n.startswith("img_neck."))
