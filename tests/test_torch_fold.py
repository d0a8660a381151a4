"""The port's BatchNorm fold (``utils/fuse_bn.py``) against the JAX
package's ``fold_batch_norms``, on BatchNorm statistics and scales drawn
away from identity (a fold of identity BatchNorms changes nothing):

(a) the port's fold of the loaded JAX variables equals the JAX fold
    loaded into the port, tensor for tensor;
(b) the folded port's serving stream equals the JAX serving stream on
    JAX-folded variables: labels on every voxel, logits to the slice
    tests' tolerance.

Small config of ``test_torch_slice.py``, float32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.models import FBOCC as JaxFBOCC
from fbbev_tpu.utils.fuse_bn import fold_batch_norms as jax_fold
from fbbev_tpu_torch.models import FBOCC
from fbbev_tpu_torch.utils.fuse_bn import fold_batch_norms, \
    perturb_batch_norms
from fbbev_tpu_torch.weights import load_jax_variables

from tests.test_torch_slice import SMALL, assert_off_voxel_faces, flow, \
    jax_cam, rig, torch_cam
from tests.test_torch_switches import jax_variables

torch.set_num_threads(1)

VARIANTS = {"small": {},
            "resnet10_no_bwd": dict(backbone_depth=10,
                                    use_backward_projection=False)}


def _jax_conv_bn_subtrees(params, prefix=()):
    """Paths of the subtrees the JAX fold folds."""
    if not isinstance(params, dict):
        return []
    out = []
    if "conv" in params and "bn" in params and "kernel" in params["conv"]:
        out.append(prefix)
    for k, v in params.items():
        out += _jax_conv_bn_subtrees(v, prefix + (k,))
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fold_state_dict_equals_jax_fold(variant):
    kw = dict(SMALL, **VARIANTS[variant])
    v = jax_variables(JaxFBOCC(**kw), seed=4)
    model = load_jax_variables(FBOCC(**kw, device="cpu"), v)
    before = copy.deepcopy(model.state_dict())
    pairs = fold_batch_norms(model)
    assert len(pairs) == len(_jax_conv_bn_subtrees(v["params"]))
    want = load_jax_variables(FBOCC(**kw, device="cpu"),
                              jax_fold(v)).state_dict()
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=0, err_msg=k)
        moved += not torch.equal(before[k], want[k])
    # every folded pair moved its conv weight and three BN tensors at
    # least, and nothing else moved
    folded = {c for c, _ in pairs} | {b for _, b in pairs}
    assert moved >= 4 * len(pairs)
    for k in want:
        if not torch.equal(before[k], want[k]):
            assert k.rsplit(".", 1)[0] in folded, k


def test_perturb_draws_every_batch_norm():
    m = FBOCC(**SMALL, device="cpu")
    perturb_batch_norms(m, torch.Generator().manual_seed(0))
    for mod in m.modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            assert mod.running_var.min() >= 0.5
            assert not torch.equal(mod.running_mean,
                                   torch.zeros_like(mod.running_mean))
            assert not torch.equal(mod.weight, torch.ones_like(mod.weight))


def test_folded_stream_matches_jax_folded_stream(monkeypatch):
    """Five frames (starts at 0 and 3): labels equal on every voxel, the
    logits within 1e-4 of their largest magnitude, the ring state as in
    the slice test."""
    from fbbev_tpu.serving import FixedRigPipeline as JaxPipeline
    from fbbev_tpu_torch.serving import FixedRigPipeline

    class JaxLogitsPipeline(JaxPipeline):
        """The JAX pipeline returning (labels, logits) of each frame."""

        def _fwd(self, mdl, imgs, meta, state, ranks_bev, bwd_terms,
                 mlp_input):
            head = mdl.occupancy_head
            real = type(head).__call__
            keep = []

            def both(self_, vox, train, return_labels=False):
                logits = real(self_, vox, train, return_labels=False)
                keep.append(logits)
                return real(self_, vox, train, return_labels=True)

            monkeypatch.setattr(type(head), "__call__", both)
            try:
                labels, new_state = super()._fwd(
                    mdl, imgs, meta, state, ranks_bev, bwd_terms, mlp_input)
            finally:
                monkeypatch.setattr(type(head), "__call__", real)
            return (labels, keep[0]), new_state

    monkeypatch.setenv("FBBEV_FORCE_POOL", "interpret")
    monkeypatch.setenv("FBBEV_FORCE_FUSE_WARP", "interpret")
    jm = JaxFBOCC(**SMALL)
    v = jax_variables(jm, seed=7)
    tm = load_jax_variables(FBOCC(**SMALL, device="cpu"), v)
    fold_batch_norms(tm)
    logits = []
    head_forward = tm.occupancy_head.forward

    def port_head(vox, return_labels=True):
        logits.append(head_forward(vox, return_labels=False))
        return head_forward(vox, return_labels=return_labels)

    tm.occupancy_head.forward = port_head
    cam = rig()
    assert_off_voxel_faces(cam)
    jp = JaxLogitsPipeline(jm, jax.tree.map(jnp.asarray, jax_fold(v)),
                           jax_cam(cam))
    tp = FixedRigPipeline(tm, torch_cam(cam))
    rng = np.random.RandomState(2)
    for i, start in enumerate([True, False, False, True, False]):
        imgs = rng.randn(1, 2, 64, 128, 3).astype(np.float32)
        rt = flow(0 if start else i)
        want, want_logits = (np.asarray(a) for a in jp(imgs, start, rt))
        got = tp(imgs, start, rt).numpy()
        assert got.shape == want.shape == (1, 40, 40, 16)
        np.testing.assert_array_equal(got, want, err_msg=str(i))
        wl, gl = want_logits, logits[-1].numpy()
        assert gl.shape == wl.shape
        assert np.abs(gl - wl).max() <= 1e-4 * np.abs(wl).max(), i
        hj = np.asarray(jp.state.history_bev)
        ht = tp.state.history_bev.numpy()
        assert np.abs(hj - ht).max() <= 1e-4 * np.abs(hj).max(), i
