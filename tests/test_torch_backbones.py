"""The port's other image backbones (VoVNet, ConvNeXt, Swin, DLA), its
DCNv3 core op and the VoVNet FB-OCC slice against the JAX package, on the
CPU in float32.

JAX variables come from ``init`` with a ``PRNGKey``, then their BatchNorm
statistics and scales, ConvNeXt's layer scales and Swin's bias tables are
drawn away from their identity values with numpy seeds (an identity
BatchNorm or a 1e-6 layer scale would hide a wrong mapping); they are
converted by ``weights.py`` and loaded with ``load_state_dict(strict=True)``.
Inputs are numpy-seeded.  Tolerances:

* network outputs (backbone features, occupancy logits): 1e-4 of max(1,
  the largest magnitude), the slice tests' measure (float32 sums in other
  orders through a random network);
* pooling, state-dict values, remat against no remat: equal;
* ``dcnv3_core``: 2e-5 absolute against JAX (``test_dcnv3.py``'s
  tolerance against its float64 oracle), and ``gradcheck``'s defaults in
  float64;
* occupancy labels: equal.
"""

import copy
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.models import convnext as JC
from fbbev_tpu.models import dla as JD
from fbbev_tpu.models import swin as JS
from fbbev_tpu.models import vovnet as JV
from fbbev_tpu.train import checkpoint_convert as CC
from fbbev_tpu.train import loop as JL
from fbbev_tpu_torch.models import convnext, dla, swin, vovnet
from fbbev_tpu_torch.models.layers import max_pool_ceil
from fbbev_tpu_torch.train import loop as PL
from fbbev_tpu_torch.weights import backbone_rules, backbone_spec, \
    jax_backbone_spec, load_jax_variables, swin_block_rules, to_state_dict

from tests.test_torch_loop import fill, jax_cfg, port_cfg, variable_shapes

torch.set_num_threads(1)

VOV = {"model.backbone_type": "VoVNetCP", "model.backbone_arch": "V-19-eSE"}


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= 1e-4, (what, err)


def perturbed(variables, seed):
    """``variables`` with the BatchNorms, layer scales and bias tables
    drawn from ``seed``."""
    rng = np.random.RandomState(seed)

    def draw(path, v):
        names = [getattr(p, "key", None) for p in path]
        v = np.asarray(v, np.float32)
        if names[0] == "batch_stats":
            return (rng.rand(*v.shape) * 0.5 + 0.5 if names[-1] == "var"
                    else rng.randn(*v.shape) * 0.1).astype(np.float32)
        if names[-1] in ("scale", "gamma"):
            return (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32)
        if names[-1] == "rel_pos_bias" or (names[-1] == "bias"
                                           and "bn" in names):
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(
        dict(variables)))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


# name, JAX module, port module, input (H, W), JAX exporter
BACKBONES = {
    "V-19-eSE": (lambda: JV.VoVNetCP("V-19-eSE"),
                 lambda: vovnet.VoVNetCP("V-19-eSE"), (64, 176),
                 lambda v: CC.export_vovnet_checkpoint(v, "V-19-eSE")),
    "V-39-eSE": (lambda: JV.VoVNetCP("V-39-eSE"),
                 lambda: vovnet.VoVNetCP("V-39-eSE"), (64, 176),
                 lambda v: CC.export_vovnet_checkpoint(v, "V-39-eSE")),
    "convnext-tiny": (lambda: JC.ConvNeXt("tiny"),
                      lambda: convnext.ConvNeXt("tiny"), (64, 176),
                      lambda v: CC.export_convnext_checkpoint(v, "tiny")),
    "swin-tiny": (lambda: JS.SwinTransformer("tiny"),
                  lambda: swin.SwinTransformer("tiny"), (64, 176),
                  lambda v: CC.export_swin_checkpoint(v, "tiny")),
    "dla34": (lambda: JD.DLANet("dla34"), lambda: dla.DLANet("dla34"),
              (64, 192), lambda v: CC.export_dla_checkpoint(v, "dla34")),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_matches_jax(name):
    """Both outputs of each backbone within 1e-4, on JAX variables loaded
    with ``strict=True``; the port's state dict equals JAX's
    ``export_*_checkpoint`` of the same variables, key for key and value
    for value; the structure read from the port module equals the one
    read from the JAX tree."""
    make_jax, make_port, (H, W), export = BACKBONES[name]
    jm = make_jax()
    x = np.random.RandomState(1).randn(2, H, W, 3).astype(np.float32)
    v = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    pm = make_port()
    spec = jax_backbone_spec(v["params"])
    assert backbone_spec(pm) == spec
    load_jax_variables(pm, v, lambda b: backbone_rules(b, "", (), spec))
    pm.eval()
    with torch.no_grad():
        got = pm(nchw(x))
    want = jax.jit(functools.partial(jm.apply, train=False))(
        v, jnp.asarray(x))
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        close(g.permute(0, 2, 3, 1).numpy(), w, f"{name} output {i}")
    wrapped = {k: {"img_backbone": t} for k, t in v.items()}
    ref = {k[len("img_backbone."):]: t for k, t in export(wrapped).items()}
    sd = {k: t for k, t in pm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert sorted(sd) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)


def test_shifted_swin_block_at_a_padded_size_matches_jax():
    """A shifted block (window 7, shift 3) on 9 x 10 maps, padded to 14 x
    14 (four windows, each region of JAX's mask present), within 1e-4;
    the block builds its mask once per padded size and device."""
    jb = JS.SwinBlock(32, 2, window=7, shift=3)
    x = np.random.RandomState(3).randn(2, 9, 10, 32).astype(np.float32)
    v = perturbed(jax.jit(jb.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    pb = swin.SwinBlock(32, 2, window=7, shift=3)
    load_jax_variables(pb, v, lambda b: swin_block_rules(b, "", ()))
    with torch.no_grad():
        got = pb(torch.from_numpy(x))
        again = pb(torch.from_numpy(x))
    close(got.numpy(), jb.apply(v, jnp.asarray(x)), "shifted block")
    assert torch.equal(got, again) and list(pb._masks) == [
        (14, 14, torch.device("cpu"))]
    m = pb.mask(14, 14, "cpu")
    assert m.shape == (4, 49, 49) and set(m.unique().tolist()) == {-100.0,
                                                                   0.0}


@pytest.mark.parametrize("hw", [(11, 11), (4, 11), (16, 44), (9, 6)])
def test_max_pool_ceil_matches_jax(hw):
    from fbbev_tpu.models.layers import max_pool_ceil as jax_pool
    x = np.random.RandomState(0).randn(2, *hw, 5).astype(np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x), 3, 2))
    got = max_pool_ceil(nchw(x), 3, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    if hw == (11, 11):
        assert got.shape == (2, 5, 5, 5)


def test_vovnet_remat_equals_no_remat_in_training():
    """V-19-eSE in train mode with each OSA block checkpointed: outputs,
    every parameter's gradient and the BatchNorm running statistics after
    one step equal those without checkpointing (a recomputation leaves the
    statistics alone)."""
    torch.manual_seed(0)
    a = vovnet.VoVNetCP("V-19-eSE").train()
    b = copy.deepcopy(a)
    b.remat = True
    x = torch.randn(2, 3, 64, 96)
    results = []
    for m in (a, b):
        outs = m(x)
        sum((o * torch.linspace(-1, 1, o.numel()).reshape(o.shape)).sum()
            for o in outs).backward()
        results.append((outs, {n: p.grad for n, p in m.named_parameters()},
                        {n: t.clone() for n, t in m.named_buffers()}))
    (oa, ga, ba), (ob, gb, bb) = results
    for u, w in zip(oa, ob):
        assert torch.equal(u, w)
    assert sorted(ga) == sorted(gb)
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n
    for n in ba:
        assert torch.equal(ba[n], bb[n]), n


# test_dcnv3.py's general configs
DCN_CONFIGS = [
    dict(kh=3, kw=3, sh=1, sw=1, ph=1, pw=1, dh=1, dw=1, G=2, scale=1.0),
    dict(kh=3, kw=3, sh=2, sw=2, ph=1, pw=1, dh=1, dw=1, G=2, scale=1.0),
    dict(kh=3, kw=3, sh=1, sw=1, ph=2, pw=2, dh=2, dw=2, G=1, scale=1.0),
    dict(kh=3, kw=5, sh=2, sw=1, ph=0, pw=2, dh=1, dw=1, G=2, scale=1.0),
    dict(kh=3, kw=3, sh=1, sw=1, ph=1, pw=1, dh=1, dw=1, G=2, scale=0.5),
]


def dcn_inputs(rng, cfg, B=2, H=7, W=9, Cg=3, dtype=np.float32):
    from fbbev_tpu_torch.ops.dcnv3 import dcnv3_output_size
    G, K = cfg["G"], cfg["kh"] * cfg["kw"]
    Ho, Wo = dcnv3_output_size((H, W), (cfg["kh"], cfg["kw"]),
                               (cfg["sh"], cfg["sw"]), (cfg["ph"], cfg["pw"]),
                               (cfg["dh"], cfg["dw"]))
    x = rng.randn(B, H, W, G * Cg).astype(dtype)
    offset = (rng.randn(B, Ho, Wo, G * K * 2) * 2).astype(dtype)
    mask = rng.rand(B, Ho, Wo, G, K).astype(dtype) + 1e-5
    mask = (mask / mask.sum(-1, keepdims=True)).reshape(B, Ho, Wo, G * K)
    kw = dict(kernel=(cfg["kh"], cfg["kw"]), stride=(cfg["sh"], cfg["sw"]),
              pad=(cfg["ph"], cfg["pw"]), dilation=(cfg["dh"], cfg["dw"]),
              groups=G, offset_scale=cfg["scale"])
    return (x, offset, mask), kw


@pytest.mark.parametrize("cfg", DCN_CONFIGS)
def test_dcnv3_core_matches_jax(cfg):
    from fbbev_tpu.ops.dcnv3 import dcnv3_core as jax_dcn
    from fbbev_tpu.ops.dcnv3 import dcnv3_output_size as jax_size
    from fbbev_tpu_torch.ops.dcnv3 import dcnv3_core, dcnv3_output_size
    args, kw = dcn_inputs(np.random.RandomState(0), cfg)
    size = ((7, 9), kw["kernel"], kw["stride"], kw["pad"], kw["dilation"])
    assert dcnv3_output_size(*size) == jax_size(*size)
    want = np.asarray(jax_dcn(*(jnp.asarray(a) for a in args), **kw))
    got = dcnv3_core(*(torch.from_numpy(a) for a in args), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="offset spatial shape"):
        dcnv3_core(torch.from_numpy(args[0]),
                   torch.from_numpy(args[1][:, 1:]),
                   torch.from_numpy(args[2][:, 1:]), **kw)


def test_dcnv3_core_gradcheck():
    """Autograd's gradients of ``dcnv3_core`` for all three inputs against
    central differences in float64 (stride (2, 1), two groups; offsets
    small enough that no sample sits on a pixel boundary)."""
    from fbbev_tpu_torch.ops.dcnv3 import dcnv3_core
    rng = np.random.RandomState(0)
    B, H, W, G, Cg, K = 1, 5, 6, 2, 2, 9
    Ho, Wo = 3, 6
    x = torch.from_numpy(rng.randn(B, H, W, G * Cg)).requires_grad_()
    off = torch.from_numpy(rng.randn(B, Ho, Wo, G * K * 2) * 0.37
                           ).requires_grad_()
    mask = torch.from_numpy(rng.rand(B, Ho, Wo, G * K)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, o, m: dcnv3_core(a, o, m, stride=(2, 1), pad=(1, 1),
                                   groups=G), (x, off, mask))


# ---------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def vov_slice():
    """The tiny config (2 cameras at 64x176, 25x25x8, T = 2; cut as
    ``test_torch_loop``'s) with a V-19-eSE backbone on both sides,
    numpy-seeded JAX variables loaded with ``strict=True``, and two frames
    of one scene (a start, then history)."""
    from fbbev_tpu.data import collate
    jc, pc = jax_cfg(**VOV), port_cfg(**VOV)
    jm = JL.build_model(jc)
    v = jax.tree_util.tree_map_with_path(fill(np.random.RandomState(12)),
                                         variable_shapes(jc))
    pm = load_jax_variables(PL.build_model(pc, device="cpu"), v)
    ds = JL.build_dataset(jc, "val")
    frames = [collate([ds[i]]) for i in (0, 1)]
    assert frames[0]["start_of_sequence"][0] and \
        not frames[1]["start_of_sequence"][0]
    return jc, pc, jm, v, pm, frames


def test_vovnet_slice_matches_jax(vov_slice, monkeypatch):
    """FBOCC with V-19-eSE against JAX's over two frames of the eval
    forward (JAX jitted, its fused history warp in the Pallas interpreter,
    as the port's eval forward fuses on K1): occupancy logits within 1e-4,
    labels equal; every port tensor comes from a JAX leaf."""
    from fbbev_tpu.models.fbocc import init_temporal_state as jax_state
    from fbbev_tpu_torch.models.fbocc import init_temporal_state
    monkeypatch.setenv("FBBEV_FORCE_FUSE_WARP", "interpret")
    jc, pc, jm, v, pm, frames = vov_slice
    assert isinstance(pm.img_backbone, vovnet.VoVNetCP)
    assert pm.backbone_arch == "V-19-eSE"
    assert set(to_state_dict(v)) == {
        k for k in pm.state_dict() if not k.endswith("num_batches_tracked")}
    grid = PL._grid_size(pm)
    js = jax_state(1, grid, pm.history_cat_num, pm.single_bev_num_channels)
    ts = init_temporal_state(1, grid, pm.history_cat_num,
                             pm.single_bev_num_channels, device="cpu")
    fwd = jax.jit(functools.partial(jm.apply, train=False))
    for i, f in enumerate(frames):
        jo, js = fwd(v, {k: jnp.asarray(x) for k, x in f.items()}, js)
        with torch.no_grad():
            po, ts = pm({k: torch.as_tensor(x) for k, x in f.items()}, ts,
                        train=False)
        want = np.asarray(jo["occ_logits"])
        got = po["occ_logits"].numpy()
        close(got, want, f"frame {i} logits")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_fold_of_vovnet_model_equals_jax_fold(vov_slice):
    """The port's BatchNorm fold of the V-19 model equals JAX's
    ``fold_batch_norms`` of the same variables loaded into the port,
    tensor for tensor to 1e-6 relative (``test_torch_fold``'s measure),
    over every {conv, bn} subtree JAX folds -- each OSA conv, concat and
    stem conv among them."""
    from fbbev_tpu.utils.fuse_bn import fold_batch_norms as jax_fold
    from fbbev_tpu_torch.utils.fuse_bn import fold_batch_norms
    from tests.test_torch_fold import _jax_conv_bn_subtrees
    jc, pc, jm, v, pm, frames = vov_slice
    model = copy.deepcopy(pm)
    pairs = fold_batch_norms(model)
    assert len(pairs) == len(_jax_conv_bn_subtrees(v["params"]))
    backbone = [c for c, _ in pairs if c.startswith("img_backbone.")]
    assert len(backbone) == len(_jax_conv_bn_subtrees(
        v["params"]["img_backbone"])) == 3 + 4 * (3 + 1)
    want = load_jax_variables(PL.build_model(pc, device="cpu"),
                              jax_fold(v)).state_dict()
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=0, err_msg=k)


def test_load_img_from_npz_loads_the_vovnet_only(vov_slice):
    """A JAX ``save_params_npz`` file of the whole model through
    ``load_img_from``: every ``img_backbone.*`` tensor of the port's state
    becomes the converted JAX value, every other one stays."""
    from fbbev_tpu.train.pretrained import save_params_npz
    from fbbev_tpu_torch.train.pretrained import load_pretrained
    from fbbev_tpu_torch.train.trainer import Trainer
    jc, pc, jm, v, pm, frames = vov_slice
    trainer = Trainer(PL.build_model(pc, device="cpu"))
    state = trainer.init_state()
    sd = to_state_dict(v)
    with tempfile.TemporaryDirectory() as d:
        npz = os.path.join(d, "warm.npz")
        save_params_npz(npz, v)
        ps = load_pretrained(state, trainer, load_img_from=npz,
                             log=lambda *a: None)
    before = trainer.unflatten(state.params)
    n = 0
    for name, t in trainer.unflatten(ps.params).items():
        if name.startswith("img_backbone."):
            np.testing.assert_array_equal(t.numpy(), sd[name], err_msg=name)
            n += 1
        else:
            assert torch.equal(t, before[name]), name
    assert n == sum(1 for k in sd if k.startswith("img_backbone.")
                    and not k.endswith(("running_mean", "running_var")))
    stats = trainer.unflatten(ps.batch_stats, "batch_stats")
    for name, t in stats.items():
        if name.startswith("img_backbone."):
            np.testing.assert_array_equal(t.numpy(), sd[name], err_msg=name)


@pytest.mark.parametrize("backbone_type, arch", [
    ("VoVNetCP", "V-39-eSE"), ("ConvNeXt", "tiny"),
    ("SwinTransformer", "tiny"), ("DLANet", "dla34")])
def test_fbocc_with_each_backbone_loads_jax_variables(backbone_type, arch):
    """``FBOCC`` of each backbone type at the small config: the JAX
    FBOCC's variables (shapes by ``eval_shape``) load with
    ``strict=True``, the neck takes the backbone's two outputs, and the
    conv / BatchNorm pairs are JAX's {conv, bn} subtrees."""
    from fbbev_tpu.models import FBOCC as JaxFBOCC
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.weights import conv_bn_pairs
    from tests.test_torch_fold import _jax_conv_bn_subtrees
    from tests.test_torch_slice import SMALL
    from tests.test_torch_switches import jax_variables
    kw = dict(SMALL, backbone_type=backbone_type, backbone_arch=arch)
    v = jax_variables(JaxFBOCC(**kw), seed=5)
    pm = load_jax_variables(FBOCC(**kw, device="cpu"), v)
    assert pm.backbone_type == backbone_type and pm.backbone_arch == arch
    assert len(conv_bn_pairs(pm)) == len(_jax_conv_bn_subtrees(v["params"]))
    with torch.no_grad():
        feats = pm.image_encoder(torch.randn(1, 2, 64, 128, 3))
    assert tuple(feats.shape) == (1, 2, 4, 8, pm.img_feat_channels)


def test_backbones_registry_and_no_jax_imports():
    """The five backbones are registered in ``BACKBONES``; the port's
    package and ``chip_smoke.py`` import neither ``jax`` nor the JAX
    package (no such import statement in any of their files), and the new
    modules run with ``jax`` unimportable."""
    import re
    import subprocess
    import sys
    from fbbev_tpu_torch.models import resnet
    from fbbev_tpu_torch.registry import BACKBONES
    for cls in (resnet.ResNet, vovnet.VoVNetCP, convnext.ConvNeXt,
                swin.SwinTransformer, dla.DLANet):
        assert BACKBONES.get(cls.__name__) is cls
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bad = re.compile(r"^\s*(from|import)\s+(jax|fbbev_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(root, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(
            os.path.join(root, "fbbev_tpu_torch")) for f in fs
        if f.endswith(".py")]
    assert len(files) > 50
    for path in files:
        with open(path) as f:
            assert not bad.search(f.read()), path
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from fbbev_tpu_torch.models.fbocc import build_backbone\n"
        "from fbbev_tpu_torch.ops.dcnv3 import dcnv3_core\n"
        "for t, a in (('VoVNetCP', 'V-19-eSE'), ('ConvNeXt', 'tiny'), "
        "('SwinTransformer', 'tiny'), ('DLANet', 'dla34')):\n"
        "    m, ch = build_backbone(t, 50, a)\n"
        "    outs = m.eval()(torch.zeros(1, 3, 64, 64))\n"
        "    assert [o.shape[1] for o in outs] == list(ch), (t, ch)\n"
        "dcnv3_core(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 72), "
        "torch.zeros(1, 4, 4, 36))\n"
        "bad = [m for m in sys.modules if m == 'fbbev_tpu' or "
        "m.startswith('fbbev_tpu.') or m.startswith('jax.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env=dict(os.environ, PYTHONPATH=root), timeout=120)
