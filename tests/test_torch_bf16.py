"""The port's served bf16 path against the JAX package's bf16, module by
module, on the CPU at the small sizes of ``test_torch_slice.py``.

Each module runs three ways on the same inputs (numpy-seeded, rounded to
bf16 once, so both packages see the same values) and the same weights
(carried across by ``fbbev_tpu_torch/weights.py``):

* J16: the JAX module at ``dtype=jnp.bfloat16``;
* P16: the port's module after ``cast(torch.bfloat16)``
  (``layers.cast_with_islands``), on its plain versions of the kernels;
* J32: the JAX module in float32, the truth.

With rel(a, b) = ||a - b|| / ||b|| over every element, each test asserts

  (a) rel(P16, J32) <= A_RATIO * rel(J16, J32) + A_FLOOR: the port's bf16
      is no farther from the truth than JAX's (A_RATIO 1.1; A_FLOOR 2^-10,
      a quarter of bf16's unit roundoff, for a module whose bf16 error is
      a draw of its rounding: two such draws differ by about that);
  (b) rel(P16, J16) <= k * rel(J16, J32) + B_FLOOR: the two bf16 results
      agree more closely than either agrees with the truth (B_FLOOR 1e-6,
      float32 summation order, for the float32 islands, where J16 equals
      J32).  k is the module's entry of ``K``, set from the honest reading
      in its comment (about twice it, at least 0.05) and below the
      readings of the planted faults.

Where the two packages round at the same points, (b) reads near 0: a
layer matches to the last bit but where a float32 sum order flips a bf16
rounding.  Through a deep stack those flips cascade -- every layer rounds
a slightly different input -- until the two bf16 results are nearly
independent draws of the same rounding error: there (the ResNet-50 trunk,
the 3D encoder's deeper levels, V-19, the whole slice) (b) reads 0.5-1.1,
k is 1.3, and (a) is the check that matters.

How JAX is run, so that its rounding points are its program's and the
port's kernels' (``fbbev_tpu/`` itself is unchanged):

* compiled with ``xla_allow_excess_precision`` off: with it on, XLA keeps
  some bf16 intermediates in float32 inside a fusion, its own choice, so
  the rounding points move by compiler decision; the depth net runs op by
  op, where even so its compiled softmax input differs from the program's;
* its 3x3x3 convs as single convs (``_DISABLED_DECOMP`` gets ``zslab``,
  the package's own switch), as the port runs them by design
  (``ROADMAP.md``: the TPU's z-slab decomposition is left out; its bf16
  partial sums round where one conv does not);
* BEVFormer's sampling on its TPU kernel (``pallas_sample.py:165``, in
  the interpreter) in place of its XLA CPU fallbacks, as the port's K3 /
  K4 are that kernel (the grid-tiled self-attention's einsum rounds each
  point's four-corner sum to bf16, which the kernel does not).

Planted faults: each moves one rounding point off the reference's (a
BatchNorm's statistics in bf16, the depth net's SE product in bf16, the
BEVFormer embeddings in bf16, a BEVFormer LayerNorm's output in bf16, a
Dense bias added inside the product, K1's epilogue folded from the bf16
time conv, the trilinear upsample rounded once, a fold computed after
the cast) and the test asserts that (b) then fails.
"""

import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import fbbev_tpu.models.layers as JL
from fbbev_tpu import geometry as jgeo
from fbbev_tpu.models import FBOCC as JaxFBOCC
from fbbev_tpu.models import bevformer as JB
from fbbev_tpu.models import centerpoint_head as JH
from fbbev_tpu.models.depth_net import get_mlp_input as jax_mlp_input
from fbbev_tpu.models.fbocc import init_temporal_state as jax_init_state
from fbbev_tpu.models.fbocc import make_backward_projection
from fbbev_tpu.ops import deform_attn as JDA
from fbbev_tpu.ops import pallas_sample as JPS
from fbbev_tpu.serving import nn_apply
from fbbev_tpu.utils import quantize as JQ
from fbbev_tpu.utils.fuse_bn import fold_batch_norms as jax_fold
from fbbev_tpu_torch import geometry as tgeo
from fbbev_tpu_torch.host_lib import compute_voxel_ranks
from fbbev_tpu_torch.models import FBOCC
from fbbev_tpu_torch.models import centerpoint_head as PH
from fbbev_tpu_torch.models import layers as tl
from fbbev_tpu_torch.models import occ_head as POH
from fbbev_tpu_torch.models.bevformer import BackwardProjection
from fbbev_tpu_torch.models.depth_net import get_mlp_input
from fbbev_tpu_torch.models.fbocc import init_temporal_state
from fbbev_tpu_torch.ops import conv_s8
from fbbev_tpu_torch.ops.deform_attn import deformable_sample_attend
from fbbev_tpu_torch.ops.pallas_pool import lss_voxel_pool_planned, \
    plan_pool
from fbbev_tpu_torch.utils.fuse_bn import fold_batch_norms
from fbbev_tpu_torch.utils.quantize import quant_conv
from fbbev_tpu_torch.weights import centerpoint_head_rules, \
    load_jax_variables

from tests.test_torch_quantize import _qp
from tests.test_torch_slice import SMALL, flow, jax_cam, jax_variables, \
    rig, torch_cam
from tests.test_torch_switches import jax_variables as jax_variables_of

torch.set_num_threads(1)

BF16 = torch.bfloat16
A_RATIO = 1.1
A_FLOOR = 2.0 ** -10
B_FLOOR = 1e-6
# k of (b) per module; the comment gives the honest reading of
# rel(P16, J16) / rel(J16, J32) on this file's inputs (the largest of the
# module's outputs), and the planted fault that (b) catches there
K = {
    "conv_bn": 0.05,              # 0; BN statistics in bf16: 1.0
    "upsample": 0.05,             # 0; trilinear rounded once: 1.07
    "image_trunk": 1.3,           # 0.81-1.01 (ResNet-50's cascade)
    "fpn": 0.05,                  # 0.001
    "depth_net": 0.05,            # 0; SE product in bf16: 0.36; a fold
                                  # after the cast: 0.99
    "lss_pool": 0.05,             # 0
    "positional_encoding": 0.0,   # equal; embeddings in bf16: 1.6e-3 abs.
    "self_attn": 0.05,            # 0.02
    "cross_attn": 0.05,           # 0
    "ffn": 0.05,                  # 0; bias inside the product: 0.98
    "layer_norms": 0.0,           # equal to B_FLOOR (float32 on both)
    "encoder_layer": 0.12,        # 0.06; a LayerNorm output in bf16: 0.21
    "backward_projection": 0.12,  # 0.05
    "sampler": 0.05,              # 0 (against JAX's TPU kernel)
    "history": 0.1,               # 0.03; K1's epilogue from bf16: 0.87
    "bev_encoder": 1.3,           # 0.06, 0.23, 0.48 (ResNet3D), to 0.65
                                  # (FPN3D): the cascade
    "occ_head": 0.1,              # 0.02; trilinear rounded once: 0.8
    "int8_epilogue": 0.05,        # 0
    "center_head": 0.1,           # 0.04
    "vovnet": 1.3,                # 0.87 (V-19's cascade)
    "slice": 1.3,                 # 0.93-1.08; labels P16 = J16 on
                                  # >= 98 % of voxels
}


@pytest.fixture(scope="module", autouse=True)
def jax_as_ported():
    """JAX's 3x3x3 convs as single convs, and its BEVFormer sampling on
    its TPU kernel (module docstring)."""
    saved = (JL._DISABLED_DECOMP, JB._use_pallas_sampling,
             JB.deformable_sample_attend_grid_tiled,
             JPS.deformable_sample_attend_pallas)
    k3 = functools.partial(saved[3], interpret=True)
    JL._DISABLED_DECOMP = saved[0] | {"zslab"}
    JB._use_pallas_sampling = lambda train, *a, **k: not train
    JB.deformable_sample_attend_grid_tiled = k3
    JPS.deformable_sample_attend_pallas = k3
    yield
    (JL._DISABLED_DECOMP, JB._use_pallas_sampling,
     JB.deformable_sample_attend_grid_tiled,
     JPS.deformable_sample_attend_pallas) = saved


def r16(a):
    """float32 numpy values rounded to bf16 once."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF16).float().numpy()


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def npf(x) -> np.ndarray:
    """A JAX or torch array as float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def reading(p16, j16, j32):
    """(rel(J16, J32), rel(P16, J32), rel(P16, J16))."""
    p16, j16, j32 = npf(p16), npf(j16), npf(j32)
    return rel(j16, j32), rel(p16, j32), rel(p16, j16)


def check(name, p16, j16, j32):
    """(a) and (b) of the module docstring for module ``name``."""
    e, a, b = reading(p16, j16, j32)
    assert a <= A_RATIO * e + A_FLOOR, (name, "(a)", a, e)
    assert b <= K[name] * e + B_FLOOR, (name, "(b)", b, e)


def fails_b(name, p16, j16, j32):
    """The planted fault's reading breaks (b)."""
    e, _, b = reading(p16, j16, j32)
    assert b > K[name] * e + B_FLOOR, (name, "fault not caught", b, e)


def compiled(fn, *args):
    """``fn`` compiled without excess precision (module docstring)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def japply(module, variables, *args, **kw):
    """``module.apply`` compiled, its arguments constants."""
    return compiled(lambda v: module.apply(v, *args, **kw),
                    variables)(variables)


def jmodel(model, variables, fn):
    """``fn`` of the bound JAX model, compiled."""
    return compiled(lambda v: nn_apply(model, v, fn), variables)(variables)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.fixture(scope="module")
def m16():
    """The small model three ways: JAX float32 / bf16 on one set of
    variables, the port's float32 and bf16 copies of them; ``cache``
    keeps JAX results that several tests read."""
    v = jax_variables()
    tm = load_jax_variables(FBOCC(**SMALL, device="cpu"), v)
    return dict(v=v, j32=JaxFBOCC(**SMALL),
                j16=JaxFBOCC(**SMALL, dtype=jnp.bfloat16), tm=tm,
                tm16=copy.deepcopy(tm).cast(BF16), cache={})


def both(m16, fn, key=None, variables=None, eager=False, dtypes=2):
    """(J16, J32) of ``fn`` on the bound JAX models (cached under
    ``key``; ``variables`` in place of the model's; ``eager``: J16 op by
    op; ``dtypes`` 1: J16 alone)."""
    if key is not None and key in m16["cache"]:
        return m16["cache"][key]
    v = m16["v"] if variables is None else variables
    out = tuple(nn_apply(m16[d], v, fn) if eager and d == "j16"
                else jmodel(m16[d], v, fn)
                for d in ("j16", "j32")[:dtypes])
    if key is not None:
        m16["cache"][key] = out
    return out


@pytest.fixture(scope="module")
def frame():
    """One frame's inputs, numpy-seeded and rounded to bf16: the images
    and the camera rig, the image features, the context and a depth
    distribution."""
    rng = np.random.RandomState(11)
    cam = rig()
    logits = rng.randn(1, 2, 80, 4, 8).astype(np.float32) * 3.0
    depth = np.exp(logits - logits.max(2, keepdims=True))
    depth /= depth.sum(2, keepdims=True)
    return dict(cam=cam, jc=jax_cam(cam),
                imgs=r16(rng.randn(1, 2, 64, 128, 3)),
                mlp=jax_mlp_input(jax_cam(cam)),
                feats=r16(rng.randn(1, 2, 4, 8, 256)),
                ctx=r16(rng.randn(1, 2, 4, 8, 64)), depth=depth)


# ------------------------------------------------------------------ 1.
def _bn_vars(rng, cout):
    return ({"scale": (rng.rand(cout) * 0.5 + 0.75).astype(np.float32),
             "bias": (rng.randn(cout) * 0.1).astype(np.float32)},
            {"mean": (rng.randn(cout) * 0.1).astype(np.float32),
             "var": (rng.rand(cout) * 0.5 + 0.5).astype(np.float32)})


# ndim, cin, cout, kernel, stride, bias, input (B, spatial...)
CONV_BN = {"2d_k3_s2": (2, 32, 48, 3, 2, False, (2, 12, 20)),
           "3d_k3_s1_bias": (3, 16, 24, 3, 1, True, (1, 10, 10, 8)),
           "3d_k1_s2_bias": (3, 16, 24, 1, 2, True, (1, 10, 10, 8))}


def conv_bn_three(case, seed=0):
    """(P16, J16, J32) of one ConvBN + relu (``layers.py:384``, its
    BatchNorm unfolded in eval: flax normalises a bf16 input in float32
    with float32 statistics, ``:737``)."""
    nd, cin, cout, k, s, bias, sp = CONV_BN[case]
    rng = np.random.RandomState(seed)
    x = r16(rng.randn(*sp, cin))
    kern = (rng.randn(*(k,) * nd, cin, cout)
            / np.sqrt(cin * k ** nd)).astype(np.float32)
    cb = (rng.randn(cout) * 0.1).astype(np.float32)
    bnp, bns = _bn_vars(rng, cout)
    v = {"params": {"conv": {"kernel": kern, **({"bias": cb} if bias
                                                 else {})}, "bn": bnp},
         "batch_stats": {"bn": bns}}
    j = [japply(JL.ConvBN(cout, k, s, padding=k // 2, ndim=nd,
                          use_bias=bias, dtype=dt), v, jnp.asarray(x),
                False) for dt in (jnp.bfloat16, jnp.float32)]
    pm = tl.conv_bn_relu(nd, cin, cout, k, s, k // 2, bias=bias).eval()
    perm = (nd + 1, nd) + tuple(range(nd))
    with torch.no_grad():
        pm[0].weight.copy_(t(np.transpose(kern, perm)))
        if bias:
            pm[0].bias.copy_(t(cb))
        pm[1].weight.copy_(t(bnp["scale"]))
        pm[1].bias.copy_(t(bnp["bias"]))
        pm[1].running_mean.copy_(t(bns["mean"]))
        pm[1].running_var.copy_(t(bns["var"]))
        tl.cast_with_islands(pm, BF16)
        p = pm(t(x, BF16).movedim(-1, 1)).movedim(1, -1)
    return p, j[0], j[1]


@pytest.mark.parametrize("case", sorted(CONV_BN))
def test_conv_bn_bf16(case):
    check("conv_bn", *conv_bn_three(case))


def test_conv_bn_planted_fault_bn_stats_in_bf16(monkeypatch):
    """The BatchNorm's statistics, scale and shift in bf16 (no island)."""
    monkeypatch.setattr(tl.BatchNorm, "float32_islands", lambda self: [])
    fails_b("conv_bn", *conv_bn_three("3d_k3_s1_bias"))


def upsample_three():
    rng = np.random.RandomState(1)
    x = r16(rng.randn(1, 5, 6, 4, 8))      # (B, D, H, W, C)
    out = (10, 12, 8)
    up, tri = compiled(lambda a, b: (
        [JL._upsample_int_axis(v, 1, 2) for v in (a, b)],
        [JL.resize_trilinear(v, out) for v in (a, b)]),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(x))(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(x))
    return x, up, out, tri


def test_upsample_bf16():
    """``upsample_int_axis`` (``layers.py:507``) and the trilinear resize
    (``:470``): JAX's chain of per-axis lerps, each rounded."""
    x, up, out, tri = upsample_three()
    check("upsample", tl.upsample_int_axis(t(x, BF16), 1, 2), *up)
    check("upsample", tl.resize_trilinear(t(x, BF16).movedim(-1, 1), out)
          .movedim(1, -1), *tri)


def test_upsample_planted_fault_trilinear_rounded_once():
    """PyTorch's trilinear kernel: one rounding where JAX's chain makes
    three."""
    x, _, out, tri = upsample_three()
    p = F.interpolate(t(x, BF16).movedim(-1, 1), size=out,
                      mode="trilinear", align_corners=False)
    fails_b("upsample", p.movedim(1, -1), *tri)


# ------------------------------------------------------------------ 2.
@torch.no_grad()
def test_image_trunk_bf16(m16, frame):
    """ResNet-50 + CustomFPN (``models/resnet.py``, ``fpn.py``): the
    whole trunk (a cascade: (a) is the check), and the FPN alone."""
    imgs = frame["imgs"]
    check("image_trunk", m16["tm16"].image_encoder(t(imgs)),
          *both(m16, lambda m: m.image_encoder(jnp.asarray(imgs), False),
                "image_encoder"))
    rng = np.random.RandomState(2)
    c45 = [r16(rng.randn(2, 4, 8, 1024)), r16(rng.randn(2, 2, 4, 2048))]
    check("fpn", m16["tm16"].img_neck([t(c, BF16).permute(0, 3, 1, 2)
                                       for c in c45]).permute(0, 2, 3, 1),
          *both(m16, lambda m: m.img_neck(
              [jnp.asarray(c).astype(m.dtype) for c in c45], False)[0]))


# ------------------------------------------------------------------ 3.
def depth_three(m16, frame, model=None):
    """(port (context, depth), (J16, J32)) of the depth net; JAX op by op
    (module docstring)."""
    model = m16["tm16"] if model is None else model
    with torch.no_grad():
        p = model.depth_net(t(frame["feats"], BF16),
                            get_mlp_input(torch_cam(frame["cam"])))
    j = both(m16, lambda m: m.depth_net(jnp.asarray(frame["feats"]),
                                        frame["mlp"], False), "depth_net",
             eager=True)
    return p, j


def test_depth_net_bf16(m16, frame):
    """CM_DepthNet: the camera branch in float32 (islands), the SE
    products float32, so the depth branch's residual stream is float32
    (``depth_net.py:75-78`` in JAX's dtype flow); the softmax in float32
    (``:93``)."""
    (pc, pd), (j16, j32) = depth_three(m16, frame)
    assert pd.dtype == torch.float32 and pc.dtype == BF16
    check("depth_net", pc, j16[0], j32[0])
    check("depth_net", pd, j16[1], j32[1])


def test_depth_net_planted_fault_se_in_bf16(m16, frame, monkeypatch):
    """The SE product rounded to the map's type."""
    def se_bf16(self, x, x_se):
        se = F.linear(x_se, self.conv_reduce.weight[:, :, 0, 0],
                      self.conv_reduce.bias)
        se = F.linear(F.relu(se), self.conv_expand.weight[:, :, 0, 0],
                      self.conv_expand.bias)
        return x * torch.sigmoid(se).to(x.dtype)[:, :, None, None]
    monkeypatch.setattr(tl.SELayer, "forward", se_bf16)
    (pc, _), (j16, j32) = depth_three(m16, frame)
    fails_b("depth_net", pc, j16[0], j32[0])


# ------------------------------------------------------------------ 4.
def test_lss_pool_bf16(m16, frame):
    """The voxel pool sums in float32 on both sides (JAX
    ``serving.py:101-103`` pools float32 casts; the port's K2 reads the
    bf16 context and sums in float32), then the z-mean is cast to the
    model's type for BEVFormer (``serving.py:111``)."""
    fp = m16["tm16"].forward_projection
    coor = tgeo.frustum_to_ego(torch.from_numpy(fp.frustum),
                               torch_cam(frame["cam"])).numpy().reshape(
                                   -1, 3)
    ranks = compute_voxel_ranks(coor, np.zeros(len(coor), np.int32),
                                fp.grid_lower, fp.grid_interval,
                                fp.grid_size, 1)
    plan = plan_pool(ranks, 1, 2, fp.D, 4, 8, fp.grid_size)
    with torch.no_grad():
        bev = lss_voxel_pool_planned(plan, t(frame["depth"]),
                                     t(frame["ctx"], BF16))
    assert bev.dtype == torch.float32

    def fn(m):
        b = m.forward_projection(frame["jc"], jnp.asarray(frame["ctx"])
                                 .astype(m.dtype), jnp.asarray(
                                     frame["depth"]))
        return jnp.mean(b, axis=3).astype(m.dtype)
    check("lss_pool", bev.mean(dim=3).to(BF16), *both(m16, fn))


# ------------------------------------------------------------------ 5.
@pytest.fixture(scope="module")
def bev_inputs(m16, frame):
    """BEVFormer's inputs: a float32 query stream (bf16 values), the
    positional map, reference points, static terms, camera features."""
    rng = np.random.RandomState(5)
    jterms = make_backward_projection(m16["j32"]).static_terms(
        frame["jc"], num_depth_bins=80, feat_hw=(4, 8))
    tterms = m16["tm16"].backward_projection.static_terms(
        torch_cam(frame["cam"]), 80, (4, 8))
    return dict(q=r16(rng.randn(1, 400, 64)), jterms=jterms, tterms=tterms,
                ref2d=jgeo.bev_reference_points_2d(20, 20)[None].astype(
                    np.float32), hw=(20, 20), pos=np.asarray(_pos(m16)),
                lss=r16(rng.randn(1, 20, 20, 64)))


def _layer(m16):
    return m16["tm16"].backward_projection.transformer.encoder.layers[0]


def _lp(m16, *path):
    p = m16["v"]["params"]["backward_projection"]
    for k in path:
        p = p[k]
    return {"params": p}


def _pos(m16):
    """JAX's positional map, (1, Q, C) float32 at any model dtype."""
    jp = JB.LearnedPositionalEncoding(num_feats=32, row_num_embed=20,
                                      col_num_embed=20)
    return japply(jp, _lp(m16, "positional_encoding"), 1).reshape(
        1, 400, 64)


@torch.no_grad()
def test_positional_encoding_bf16(m16, bev_inputs):
    """A float32 ``nn.Embed`` in JAX (``bevformer.py:94-97``): float32 on
    both sides, equal."""
    p = m16["tm16"].backward_projection.positional_encoding(1)
    assert p.dtype == torch.float32
    check("positional_encoding", p, bev_inputs["pos"], bev_inputs["pos"])


def test_positional_encoding_planted_fault_embeddings_in_bf16(
        m16, bev_inputs, monkeypatch):
    monkeypatch.setattr(BackwardProjection, "float32_islands",
                        lambda self: [])
    tm16 = copy.deepcopy(m16["tm"]).cast(BF16)
    with torch.no_grad():
        p = tm16.backward_projection.positional_encoding(1)
    fails_b("positional_encoding", p, bev_inputs["pos"], bev_inputs["pos"])


def _depth_dist(seed=6):
    d = np.random.RandomState(seed).rand(1, 2, 80, 4, 8).astype(np.float32)
    return d / d.sum(2, keepdims=True)


@torch.no_grad()
def test_self_and_cross_attention_bf16(m16, bev_inputs, frame):
    """The BEV self-attention (``bevformer.py:103-175``) and the
    depth-aware cross-attention (``:182-468``): a float32 query stream
    in, bf16 Dense layers (input cast, bias added after the product),
    the attention weights times the float32 depth weights float32, the
    sampled sums float32 through the camera average, a float32 residual
    out."""
    bi = bev_inputs
    args = (jnp.asarray(bi["q"]), jnp.asarray(bi["pos"]))
    j = [japply(JB.DeformableSelfAttention(embed_dims=64, dtype=dt),
                _lp(m16, "layer0", "self_attn"), *args,
                jnp.asarray(bi["ref2d"]), bi["hw"])
         for dt in (jnp.bfloat16, jnp.float32)]
    p = _layer(m16).attentions[0](t(bi["q"]), t(bi["pos"]),
                                  t(bi["ref2d"]), bi["hw"])
    assert p.dtype == torch.float32 and j[0].dtype == jnp.float32
    check("self_attn", p, *j)
    depth = _depth_dist()
    j = [japply(JB.DepthAwareSpatialCrossAttention(
        embed_dims=64, num_cams=2, max_queries_per_cam=256, dtype=dt),
        _lp(m16, "layer0", "cross_attn"), *args,
        jnp.asarray(frame["ctx"]).astype(dt), None, None, None,
        jnp.asarray(depth), False, static_terms=bi["jterms"])
        for dt in (jnp.bfloat16, jnp.float32)]
    p = _layer(m16).attentions[1](t(bi["q"]), t(bi["pos"]),
                                  t(frame["ctx"], BF16), t(depth),
                                  bi["tterms"])
    assert p.dtype == torch.float32 and j[0].dtype == jnp.float32
    check("cross_attn", p, *j)


def ffn_three(m16, x):
    j = [japply(JB.FFN(embed_dims=64, feedforward_channels=256, dtype=dt),
                _lp(m16, "layer0", "ffn"), jnp.asarray(x))
         for dt in (jnp.bfloat16, jnp.float32)]
    with torch.no_grad():
        p = _layer(m16).ffns[0](t(x))
    return p, j[0], j[1]


@torch.no_grad()
def test_ffn_and_layer_norms_bf16(m16, bev_inputs):
    """The FFN's bf16 Dense layers on a float32 stream, float32 residual;
    the three LayerNorms in float32 on float32 parameters (flax's
    ``nn.LayerNorm`` without a dtype, ``bevformer.py:518``)."""
    x = bev_inputs["q"]
    p, j16, j32 = ffn_three(m16, x)
    assert p.dtype == torch.float32
    check("ffn", p, j16, j32)
    for i in range(3):
        j = japply(fnn.LayerNorm(epsilon=1e-5),
                   _lp(m16, "layer0", f"norm{i + 1}"), jnp.asarray(x))
        p = _layer(m16).norms[i](t(x))
        assert p.dtype == torch.float32 and j.dtype == jnp.float32
        check("layer_norms", p, j, j)


def test_ffn_planted_fault_bias_inside_the_product(m16, bev_inputs,
                                                   monkeypatch):
    """``nn.Linear``'s bias added inside the product (one rounding),
    where flax's Dense adds it to the rounded product."""
    monkeypatch.setattr(tl.Linear, "forward", lambda self, x: F.linear(
        x.to(self.weight.dtype), self.weight, self.bias))
    fails_b("ffn", *ffn_three(m16, bev_inputs["q"]))


def encoder_layer_three(m16, bi, frame):
    depth = _depth_dist()
    j = [japply(JB.BEVFormerEncoderLayer(
        embed_dims=64, feedforward_channels=256, num_cams=2,
        max_queries_per_cam=256, dtype=dt), _lp(m16, "layer0"),
        jnp.asarray(bi["q"]), jnp.asarray(bi["pos"]),
        jnp.asarray(bi["ref2d"]), bi["hw"],
        jnp.asarray(frame["ctx"]).astype(dt), None, None, None,
        jnp.asarray(depth), False, static_terms=bi["jterms"])
        for dt in (jnp.bfloat16, jnp.float32)]
    with torch.no_grad():
        p = _layer(m16)(t(bi["q"]), t(bi["pos"]), t(bi["ref2d"]), bi["hw"],
                        t(frame["ctx"], BF16), t(depth), bi["tterms"])
    return p, j[0], j[1]


def test_encoder_layer_bf16(m16, bev_inputs, frame):
    """One whole encoder layer (self-attention, norm, cross-attention,
    norm, FFN, norm): the query stream float32 throughout."""
    p, j16, j32 = encoder_layer_three(m16, bev_inputs, frame)
    m16["cache"]["encoder_layer"] = (j16, j32)
    check("encoder_layer", p, j16, j32)


def test_encoder_layer_planted_fault_layer_norm_in_bf16(m16, bev_inputs,
                                                        frame, monkeypatch):
    """One LayerNorm's output rounded to bf16."""
    norm = _layer(m16).norms[1]
    real = norm.forward
    monkeypatch.setattr(norm, "forward",
                        lambda x: real(x).to(BF16).float())
    fails_b("encoder_layer", *encoder_layer_three(m16, bev_inputs, frame))


@torch.no_grad()
def test_backward_projection_bf16(m16, frame, bev_inputs):
    """The whole head: the seeded query float32 (a float32 embedding plus
    the bf16 LSS BEV), the refined BEV float32 out."""
    bi = bev_inputs
    p = m16["tm16"].backward_projection(
        t(frame["ctx"], BF16), t(bi["lss"], BF16), t(frame["depth"]),
        bi["tterms"])
    assert p.dtype == torch.float32
    check("backward_projection", p, *both(m16, lambda m: m.
          backward_projection(jnp.asarray(frame["ctx"]).astype(m.dtype),
                              jnp.asarray(bi["lss"]).astype(m.dtype), None,
                              jnp.asarray(frame["depth"]), False,
                              static_terms=bi["jterms"])))


# ------------------------------------------------------------------ 6.
def test_sampler_dtypes_bf16():
    """``ops/deform_attn.py``: bf16 values, float32 locations and weights,
    float32 sums; the combined tent x attention weight rounded to the
    value's type, as JAX's TPU kernel (``pallas_sample.py:65``, in the
    interpreter).  JAX's XLA one-hot form on the CPU rounds the sampled
    values instead: (a) holds against it too."""
    rng = np.random.RandomState(7)
    B, H, W, heads, hd, Q, P = 1, 6, 10, 4, 8, 24, 4
    v = r16(rng.randn(B, H * W, heads, hd))
    loc = rng.rand(B, Q, heads, P, 2).astype(np.float32)
    attn = rng.rand(B, Q, heads, P).astype(np.float32)
    p = deformable_sample_attend(t(v, BF16), (H, W), t(loc), t(attn))
    assert p.dtype == torch.float32
    args = (jnp.asarray(loc), jnp.asarray(attn))
    xla = jax.jit(functools.partial(JDA.deformable_sample_attend,
                                    spatial_shape=(H, W)))
    j32 = xla(jnp.asarray(v), loc=args[0], attn=args[1])
    check("sampler", p, JPS.deformable_sample_attend_pallas(
        jnp.asarray(v, jnp.bfloat16), (H, W), *args), j32)
    e, a, _ = reading(p, xla(jnp.asarray(v, jnp.bfloat16), loc=args[0],
                             attn=args[1]), j32)
    assert a <= A_RATIO * e + A_FLOOR, (a, e)


# ------------------------------------------------------------------ 7.
def _meta(start, step):
    return dict(start_of_sequence=np.full((1,), start),
                sequence_group_idx=np.zeros((1,), np.int32),
                curr_to_prev_ego_rt=flow(0 if start else step))


HIST_BEVS = [r16(np.random.RandomState(8 + i).randn(1, 20, 20, 8, 64) * 0.5)
             for i in range(2)]


def jax_history(m16, ring, monkeypatch):
    """JAX's two steps (a start, then a step with ego motion on the
    history it left), each dtype compiled once; cached."""
    key = ("history", ring)
    if key in m16["cache"]:
        return m16["cache"][key]
    if ring:
        monkeypatch.setenv("FBBEV_FORCE_FUSE_WARP", "interpret")
    bda = jnp.eye(3)[None]
    out = []
    for d in ("j16", "j32"):
        model = m16[d]
        st = jax_init_state(1, (20, 20, 8), 2, 64, dtype=model.dtype)
        metas = [{k: jnp.asarray(x) for k, x in _meta(i == 0, i).items()}
                 for i in range(2)]
        step = compiled(lambda v, b, s, mt: nn_apply(
            model, v, lambda m: m.fuse_history(b, s, mt, bda, True,
                                               False)[:2]),
            m16["v"], jnp.asarray(HIST_BEVS[0]), st, metas[0])
        res = []
        for b, mt in zip(HIST_BEVS, metas):
            fused, st = step(m16["v"], jnp.asarray(b), st, mt)
            res.append((fused, st.history_bev))
        out.append(res)
    m16["cache"][key] = out
    return out


def port_history(m16, ring):
    tm16 = m16["tm16"]
    st = init_temporal_state(1, (20, 20, 8), 2, 64, dtype=BF16,
                             device="cpu")
    fuse = tm16.fuse_history if ring else tm16.fuse_history_aged
    res = []
    with torch.no_grad():
        for i, b in enumerate(HIST_BEVS):
            meta = {k: torch.as_tensor(x)
                    for k, x in _meta(i == 0, i).items()}
            fused, st, _ = fuse(t(b), st, meta, torch.eye(3)[None])
            res.append((fused, st.history_bev))
    return res


@pytest.mark.parametrize("ring", [True, False], ids=["k1", "aged"])
def test_history_fusion_bf16(m16, monkeypatch, ring):
    """Two steps of the history fusion in the model's type, as JAX fuses
    (``fbocc.py:308-311``, ``:373``, ``:443-474``): ``k1`` on K1 with its
    epilogue (JAX's fused kernel in the interpreter; the epilogue folds
    the BatchNorm into the float32 time conv), ``aged`` the age-ordered
    fallback (the warp's weights rounded to the history's type, as JAX's
    eval warps round them).  The fused BEV and the new history."""
    j16, j32 = jax_history(m16, ring, monkeypatch)
    p = port_history(m16, ring)
    for i in range(2):
        assert p[i][0].dtype == BF16 and p[i][1].dtype == BF16
        check("history", p[i][0], j16[i][0], j32[i][0])
    check("history", p[1][1], j16[1][1], j32[1][1])


def test_history_planted_fault_k1_epilogue_from_bf16(m16, monkeypatch):
    """The time conv cast with the model (no island): K1's epilogue
    folds the BatchNorm into its bf16 values."""
    j16, j32 = jax_history(m16, True, monkeypatch)
    monkeypatch.setattr(tl.TimeEmbedConvBN, "float32_islands",
                        lambda self: [])
    faulty = dict(m16, tm16=copy.deepcopy(m16["tm"]).cast(BF16))
    fails_b("history", port_history(faulty, True)[0][0], j16[0][0],
            j32[0][0])


# ------------------------------------------------------------------ 8.
@torch.no_grad()
def test_bev_encoder_bf16(m16):
    """ResNet3D's three levels and FPN3D's (``models/resnet3d.py``,
    ``fpn3d.py``; FPN3D's upsamples JAX's per-axis chain): JAX takes the
    fused BEV as float32 and its first conv casts it (``fbocc.py:558``),
    the port takes it bf16."""
    fused = r16(np.random.RandomState(13).randn(1, 20, 20, 8, 128))
    tm16 = m16["tm16"]
    x = tm16.img_bev_encoder_backbone(t(fused, BF16).permute(0, 4, 1, 2, 3))
    vox = tm16.img_bev_encoder_neck(x)
    def fn(m):
        xs = m.img_bev_encoder_backbone(jnp.asarray(fused), False)
        return xs, m.img_bev_encoder_neck(xs, False)
    j16, j32 = both(m16, fn)
    for i in range(3):
        check("bev_encoder", x[i].permute(0, 2, 3, 4, 1), j16[0][i],
              j32[0][i])
        check("bev_encoder", vox[i].permute(0, 2, 3, 4, 1), j16[1][i],
              j32[1][i])


# ------------------------------------------------------------------ 9.
OCC_VOX = [r16(np.random.RandomState(14 + s).randn(1, 20 // s, 20 // s,
                                                   8 // s, 32))
           for s in (1, 2, 4)]


def port_occ(m16):
    with torch.no_grad():
        return m16["tm16"].occupancy_head(
            [t(x, BF16).permute(0, 4, 1, 2, 3) for x in OCC_VOX],
            return_labels=False)


def jax_occ(m16):
    return both(m16, lambda m: m.occupancy_head(
        [jnp.asarray(x).astype(m.dtype) for x in OCC_VOX], False), "occ")


def test_occ_head_bf16(m16):
    """The occupancy head: the blend weights JAX's bf16 softmax
    (``occ_head.py:102``, ``layers.softmax``), the upsamples its per-axis
    chain, the logits float32 (``:128``), the labels their argmax
    (``:154``; port ``:114-116``), equal on >= 99.9 % of voxels."""
    p = port_occ(m16)
    j16, j32 = jax_occ(m16)
    assert p.dtype == torch.float32 and j16.dtype == jnp.float32
    check("occ_head", p, j16, j32)
    agree = (npf(p).argmax(-1) == npf(j16).argmax(-1)).mean()
    assert agree >= 0.999, agree


def test_occ_head_planted_fault_trilinear_rounded_once(m16, monkeypatch):
    """The blend's upsamples on PyTorch's trilinear kernel."""
    monkeypatch.setattr(POH, "resize_trilinear", lambda x, size, rows: (
        F.interpolate(x, size=tuple(size), mode="trilinear",
                      align_corners=False)))
    fails_b("occ_head", port_occ(m16), *jax_occ(m16))


# --------------------------------------------------------- 10 and 15.
def test_slice_stream_bf16(m16, monkeypatch):
    """The serving slice: two frames of ``test_torch_slice``'s stream (a
    start, then a step with ego motion) through the eval forward of both
    packages in bf16 (each dtype compiled once), history on K1 (JAX's in
    the interpreter): the logits under (a) and (b); the labels, P16
    against J16, on >= 98 % of voxels; the temporal state in the model's
    type on both sides (JAX ``serving.py:92-94``), its history under (a)
    and (b)."""
    monkeypatch.setenv("FBBEV_FORCE_FUSE_WARP", "interpret")
    cam = rig()
    rng = np.random.RandomState(1)
    frames = [r16(rng.randn(1, 2, 64, 128, 3)) for _ in range(2)]
    batches = [dict(imgs=imgs, **cam, **_meta(i == 0, i))
               for i, imgs in enumerate(frames)]
    res = {}
    for d in ("j16", "j32"):
        model = m16[d]
        st = jax_init_state(1, (20, 20, 8), 2, 64, dtype=model.dtype)
        jb = [{k: jnp.asarray(x) for k, x in b.items()} for b in batches]
        step = compiled(lambda v, b, s: model.apply(v, b, s, False),
                        m16["v"], jb[0], st)
        outs = []
        for b in jb:
            o, st = step(m16["v"], b, st)
            outs.append(o["occ_logits"])
        res[d] = (outs, st.history_bev)
    assert res["j16"][1].dtype == jnp.bfloat16
    st = init_temporal_state(1, (20, 20, 8), 2, 64, dtype=BF16,
                             device="cpu")
    outs = []
    with torch.no_grad():
        for b in batches:
            o, st = m16["tm16"]({k: torch.as_tensor(x) for k, x in
                                 b.items()}, st)
            outs.append(o["occ_logits"])
    assert st.history_bev.dtype == BF16
    check("slice", st.history_bev, res["j16"][1], res["j32"][1])
    for i in range(2):
        check("slice", outs[i], res["j16"][0][i], res["j32"][0][i])
        agree = (npf(outs[i]).argmax(-1)
                 == npf(res["j16"][0][i]).argmax(-1)).mean()
        assert agree >= 0.98, (i, agree)


# ----------------------------------------------------------------- 11.
def folded_port(m16, fold_after_cast=False):
    pm = copy.deepcopy(m16["tm"])
    if fold_after_cast:
        pm.cast(BF16)
        fold_batch_norms(pm)
    else:
        fold_batch_norms(pm)
        pm.cast(BF16)
    return pm


def folded_depth(m16, frame):
    """JAX's folded bf16 depth net against the unfolded float32 one."""
    j16 = both(m16, lambda m: m.depth_net(
        jnp.asarray(frame["feats"]), frame["mlp"], False), "folded_depth",
        variables=jax_fold(m16["v"]), eager=True, dtypes=1)[0]
    return j16, depth_three(m16, frame)[1][1]


def test_fold_bf16(m16, frame):
    """``utils/fuse_bn.py``: fold in float32, then cast (``:32``), as JAX
    folds its float32 variables and computes in bf16: the depth net and
    the image trunk of the folded bf16 model against JAX's, the truth the
    unfolded float32 model."""
    pm = folded_port(m16)
    j16, j32 = folded_depth(m16, frame)
    p, _ = depth_three(m16, frame, pm)
    check("depth_net", p[0], j16[0], j32[0])
    imgs = frame["imgs"]
    with torch.no_grad():
        p = pm.image_encoder(t(imgs))
    fn = lambda m: m.image_encoder(jnp.asarray(imgs), False)  # noqa: E731
    check("image_trunk", p, jmodel(m16["j16"], jax_fold(m16["v"]), fn),
          both(m16, fn, "image_encoder")[1])


def test_fold_planted_fault_fold_after_cast(m16, frame):
    """The fold computed on the bf16 model's weights."""
    j16, j32 = folded_depth(m16, frame)
    p, _ = depth_three(m16, frame, folded_port(m16, fold_after_cast=True))
    fails_b("depth_net", p[0], j16[0], j32[0])


# ----------------------------------------------------------------- 12.
def test_int8_epilogue_bf16():
    """One int8 conv (``utils/quantize.py``): the dequantize epilogue
    (scale and bias in float32) rounded once to the model's type on both
    sides (JAX ``quantize.py:382-400``, ``_out_dtype``); the truth is the
    float32 model's int8 conv.  A float32 input is quantized uncast, as
    JAX quantizes it (the depth net's residual stream)."""
    rng = np.random.RandomState(9)
    cin, cout = 16, 24
    w_q = rng.randint(-127, 128, (cout, cin, 3, 3)).astype(np.int8)
    s_w = (rng.rand(cout) * 0.01 + 0.001).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    x = (rng.randn(2, cin, 9, 11) * 2.0).astype(np.float32)
    j, qp = _qp(w_q, 0.05, s_w, b)
    m = tl.conv(2, cin, cout, 3, 1, 1, bias=True).to(BF16)
    for xin in (x, r16(x)):
        xj = jnp.asarray(np.moveaxis(xin, 1, -1))
        ref = [JQ._quant_nn_conv(fnn.Conv(cout, (3, 3), padding=[(1, 1)] * 2,
                                          dtype=dt), j, xj)
               for dt in (jnp.bfloat16, jnp.float32)]
        assert ref[0].dtype == jnp.bfloat16
        y = quant_conv(m, qp, t(xin))
        assert y.dtype == BF16
        check("int8_epilogue", y.movedim(1, -1), *ref)
    # the float32 input's int8 levels are not those of its bf16 rounding
    _, acc = conv_s8.conv_s8(t(x), qp, 1, 1, 1, 1, return_sums=True)
    _, acc16 = conv_s8.conv_s8(t(x, BF16), qp, 1, 1, 1, 1,
                               return_sums=True)
    assert not torch.equal(acc, acc16)


# ----------------------------------------------------------------- 13.
def test_center_head_bf16():
    """The CenterPoint head in bf16: every output float32 (JAX
    ``centerpoint_head.py:69``)."""
    rng = np.random.RandomState(10)
    bev = r16(rng.randn(1, 12, 12, 32))
    shapes = jax.eval_shape(JH.CenterHead(in_channels=32).init,
                            jax.random.PRNGKey(0), bev)

    def fill(path, s):
        names = [getattr(p, "key", None) for p in path]
        if names[0] == "batch_stats":
            return (rng.rand(*s.shape) * 0.5 + 0.5 if names[-1] == "var"
                    else rng.randn(*s.shape) * 0.1).astype(np.float32)
        if names[-1] == "kernel":
            return (rng.randn(*s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if names[-1] == "scale":
            return (rng.rand(*s.shape) * 0.5 + 0.75).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)
    v = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    pm = load_jax_variables(PH.CenterHead(32).eval(), v,
                            lambda b: centerpoint_head_rules(b, "", (), 6))
    tl.cast_with_islands(pm, BF16)
    with torch.no_grad():
        got = pm(t(bev, BF16).permute(0, 3, 1, 2))
    j16, j32 = (japply(JH.CenterHead(in_channels=32, dtype=dt), v,
                       jnp.asarray(bev))
                for dt in (jnp.bfloat16, jnp.float32))
    for g, a, b in zip(got, j16, j32):
        for k in b:
            assert g[k].dtype == torch.float32 and a[k].dtype == jnp.float32
            check("center_head", g[k], a[k], b[k])


# ----------------------------------------------------------------- 14.
VOV = dict(SMALL, backbone_type="VoVNetCP", backbone_arch="V-19-eSE")


def test_vovnet_fold_gap_bf16(frame):
    """V-19-eSE (VoVNet-99's block widths, fewer blocks; BatchNorms away
    from identity): the unfolded and the folded bf16 image encoders of
    both packages under (a) and (b) against the unfolded float32 one, and
    the fold's gap, rel(folded bf16, unfolded bf16), of the port within
    A_RATIO of JAX's (``utils/fuse_bn.py`` on both sides)."""
    jm = JaxFBOCC(**VOV)
    v = jax_variables_of(jm, seed=3)
    tm = load_jax_variables(FBOCC(**VOV, device="cpu"), v)
    jm16 = JaxFBOCC(**VOV, dtype=jnp.bfloat16)
    imgs = frame["imgs"]
    fn = lambda m: m.image_encoder(jnp.asarray(imgs), False)  # noqa: E731
    j32 = jmodel(jm, v, fn)
    j16, j16f = (jmodel(jm16, w, fn) for w in (v, jax_fold(v)))
    unf = copy.deepcopy(tm).cast(BF16)
    fold_batch_norms(tm)
    fol = tm.cast(BF16)
    with torch.no_grad():
        p16, p16f = (m.image_encoder(t(imgs)) for m in (unf, fol))
    check("vovnet", p16, j16, j32)
    check("vovnet", p16f, j16f, j32)
    gap_j, gap_p = rel(npf(j16f), npf(j16)), rel(npf(p16f), npf(p16))
    assert gap_p <= A_RATIO * gap_j + A_FLOOR, (gap_p, gap_j)
