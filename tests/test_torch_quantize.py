"""The port's int8 serving (``fbbev_tpu_torch/utils/quantize.py``,
``ops/conv_s8.py``, ``FixedRigPipeline.enable_int8``, the two tools)
against the JAX package's ``fbbev_tpu/utils/quantize.py`` on the CPU.

The JAX side runs as ``tests/test_quantize.py`` runs it; the port runs the
int8 conv's plain version (the kernel is held against it on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Tolerances:

* calibration statistics, absmax and p999, to rtol 1e-6 (p999 is JAX's
  float32 interpolation, reproduced);
* ``w_q`` byte for byte, ``s_w``, ``s_x``, ``m_x``, ``b`` to rtol 1e-6;
* the int32 sums of the four JAX int8 conv forms exactly, their outputs
  to rtol 1e-6 of the largest magnitude;
* the tiny pipeline, int8 on both sides: labels agree on >= 0.99 of the
  voxels (an activation a float32 ulp apart can round to the next int8
  level on one side).
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbbev_tpu.models.layers import Conv1x1x1Dense, Conv3DZFold, \
    Conv3DZSlab, ConvBN
from fbbev_tpu.utils import quantize as JQ
from fbbev_tpu_torch.models.layers import bn, conv
from fbbev_tpu_torch.ops import conv_s8
from fbbev_tpu_torch.utils import quantize as Q

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "fbbev_tpu_torch", "configs",
                    "fbocc-r50-tiny_synthetic.py")


class JaxTiny(fnn.Module):
    """``tests/test_quantize.py``'s TinyNet."""

    @fnn.compact
    def __call__(self, x2d, x3d, train: bool = False):
        a = ConvBN(16, 3, dtype=jnp.float32, name="c2d")(x2d, train)
        a = fnn.Conv(8, (1, 1), use_bias=True, name="proj")(a)
        b = Conv3DZSlab(8, name="c3d")(x3d)
        c = Conv1x1x1Dense(4, name="pw")(b)
        return a, b, c


class PortConvBN(torch.nn.Module):
    """JAX's ``ConvBN`` (conv, BN, relu) under its module names."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = conv(2, cin, cout, k, 1, k // 2)
        self.bn = bn(2, cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class PortTiny(torch.nn.Module):
    """Its twin: NCHW and (B, C, Y, X, Z) inputs, its modules named so
    that each name with ``/`` for ``.`` is the JAX module path
    (``quantize.jax_paths``)."""

    def __init__(self):
        super().__init__()
        self.c2d = PortConvBN(4, 16, 3)
        self.proj = torch.nn.Conv2d(16, 8, 1, bias=True)
        self.c3d = torch.nn.Conv3d(4, 8, 3, padding=1, bias=False)
        self.pw = torch.nn.Conv3d(8, 4, 1, bias=False)

    def forward(self, x2d, x3d):
        b = self.c3d(x3d)
        return self.proj(self.c2d(x2d)), b, self.pw(b)


# the quantized convs' JAX module paths
TINY_PATHS = ("c2d/conv", "c3d", "proj", "pw")


def _jax_path(name):
    return name.replace(".", "/")


def _port_name(path):
    return path.replace("/", ".")


def _port_kernel(k):
    k = np.asarray(k, np.float32)
    return np.transpose(k, (3, 2, 0, 1) if k.ndim == 4 else (4, 3, 0, 1, 2))


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.RandomState(0)
    x2d = rng.randn(2, 8, 8, 4).astype(np.float32)
    x3d = rng.randn(1, 6, 6, 4, 4).astype(np.float32)
    x2d[..., 1] *= 30.0  # an outlier channel
    net = JaxTiny()
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(x2d),
                                  jnp.asarray(x3d))
    p = jax.tree.map(np.asarray, variables["params"])
    port = PortTiny()
    sd = {"c2d.conv.weight": _port_kernel(p["c2d"]["conv"]["kernel"]),
          "proj.weight": _port_kernel(p["proj"]["kernel"]),
          "proj.bias": p["proj"]["bias"],
          "c3d.weight": _port_kernel(p["c3d"]["kernel"]),
          "pw.weight": _port_kernel(p["pw"]["kernel"])}
    state = port.state_dict()
    state.update({k: torch.from_numpy(np.array(v))
                  for k, v in sd.items()})
    port.load_state_dict(state)
    port.eval()
    return net, variables, x2d, x3d, port


def _jax_scales(net, variables, x2d, x3d):
    with JQ.collect_scales():
        _, mut = net.apply(variables, jnp.asarray(x2d), jnp.asarray(x3d),
                           mutable=[JQ._QCOLL])
    return JQ.scales_from_stats(mut[JQ._QCOLL])


def _port_scales(port, x2d, x3d, act_stat):
    with Q.collect_scales(port, act_stat) as stats, torch.no_grad():
        port(torch.from_numpy(x2d).permute(0, 3, 1, 2),
             torch.from_numpy(x3d).permute(0, 4, 1, 2, 3))
    return {_jax_path(k): v for k, v in Q.scales_from_stats(stats).items()}


@pytest.mark.parametrize("act_stat", ["absmax", "p999"])
def test_calibration_matches_jax(tiny, monkeypatch, act_stat):
    net, variables, x2d, x3d, port = tiny
    monkeypatch.setenv("FBBEV_INT8_ACT_STAT", act_stat)
    want = _jax_scales(net, variables, x2d, x3d)
    got = _port_scales(port, x2d, x3d, act_stat)
    assert sorted(got) == sorted(want) == sorted(TINY_PATHS)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_p999_beyond_torch_quantile():
    """More than 2^24 values (``torch.quantile``'s limit): the flagship's
    first layer-1 input holds 17.3 M."""
    rng = np.random.RandomState(3)
    x = rng.standard_exponential((1, 2, 2900, 2900)).astype(np.float32)
    assert x.size > 2 ** 24
    got = Q.channel_stat(torch.from_numpy(x), "p999").numpy()
    want = np.asarray(jnp.quantile(jnp.asarray(
        np.abs(x).transpose(0, 2, 3, 1).reshape(-1, 2)), 0.999, axis=0))
    np.testing.assert_allclose(got, want, rtol=1e-6)


VARIANTS = {"smooth": dict(), "alpha_0.3": dict(alpha=0.3),
            "per_tensor": dict(per_tensor=True), "absmax": dict(),
            "legacy_scalar": dict()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_build_qparams_matches_jax(tiny, monkeypatch, variant):
    net, variables, x2d, x3d, port = tiny
    if variant == "absmax":
        monkeypatch.setenv("FBBEV_INT8_ACT_STAT", "absmax")
    scales = _jax_scales(net, variables, x2d, x3d)
    if variant == "legacy_scalar":
        scales = {k: float(np.asarray(v).max()) for k, v in scales.items()}
    kw = VARIANTS[variant]
    jkw = {}
    if "alpha" in kw:
        jkw["alpha"] = kw["alpha"]
    if kw.get("per_tensor"):
        monkeypatch.setenv("FBBEV_INT8_CALIB", "tensor")
    want = JQ.build_qparams(variables, scales, exclude=(), **jkw)
    got = Q.build_qparams(port, {_port_name(k): v for k, v in scales.items()},
                          exclude=(), **kw)
    assert sorted(_jax_path(k) for k in got) == sorted(want)
    smoothed = 0
    for name, qp in got.items():
        w = want[_jax_path(name)]
        wq = _port_kernel(np.asarray(w["w_q"], np.float32))
        assert qp["w_q"].dtype == torch.int8
        np.testing.assert_array_equal(qp["w_q"].numpy(), wq.astype(np.int8),
                                      err_msg=name)
        np.testing.assert_allclose(qp["s_w"].numpy(), w["s_w"], rtol=1e-6)
        np.testing.assert_allclose(float(qp["s_x"]), float(w["s_x"]),
                                   rtol=1e-6)
        assert (qp["m_x"] is None) == (w["m_x"] is None), name
        if w["m_x"] is not None:
            smoothed += 1
            np.testing.assert_allclose(qp["m_x"].numpy(), w["m_x"],
                                       rtol=1e-6)
        assert (qp["b"] is None) == (w["b"] is None), name
        if w["b"] is not None:
            np.testing.assert_allclose(qp["b"].numpy(), w["b"], rtol=1e-6)
        np.testing.assert_array_equal(
            qp["scale"].numpy(),
            (np.float32(qp["s_x"]) * qp["s_w"].numpy()).astype(np.float32))
    smooth = variant in ("smooth", "alpha_0.3", "absmax")
    assert smoothed == (len(got) if smooth else 0)


def test_exclusions_read_jax_paths(tiny):
    net, variables, x2d, x3d, port = tiny
    scales = {_port_name(k): v for k, v in
              _jax_scales(net, variables, x2d, x3d).items()}
    got = Q.build_qparams(port, scales, exclude=(r"proj", r"c2d/conv"))
    assert sorted(got) == ["c3d", "pw"]


def test_scales_json_roundtrip(tiny):
    net, variables, x2d, x3d, port = tiny
    scales = _port_scales(port, x2d, x3d, "p999")
    scales["legacy"] = 0.25
    rt = Q.scales_from_json(json.loads(json.dumps(Q.scales_to_json(scales))))
    assert sorted(rt) == sorted(scales)
    for k in scales:
        np.testing.assert_allclose(rt[k], scales[k], rtol=1e-7)
    assert rt["legacy"] == 0.25


# --------------------------------------------------------------------------
# the plain int8 conv against JAX's four forms

def _qp(w_q, s_x, s_w, b=None, m_x=None):
    """Port parameters (port layout) and JAX's (JAX layout) of one conv."""
    j = {"w_q": jnp.asarray(np.transpose(
            w_q, (2, 3, 1, 0) if w_q.ndim == 4 else (2, 3, 4, 1, 0))),
         "s_w": jnp.asarray(s_w), "s_x": jnp.float32(s_x),
         "m_x": None if m_x is None else jnp.asarray(m_x),
         "b": None if b is None else jnp.asarray(b)}
    t = {"w_q": torch.from_numpy(w_q), "s_w": torch.from_numpy(s_w),
         "s_x": torch.tensor(np.float32(s_x)),
         "m_x": None if m_x is None else torch.from_numpy(m_x),
         "b": None if b is None else torch.from_numpy(b),
         "scale": torch.from_numpy((np.float32(s_x) * s_w)
                                   .astype(np.float32))}
    return j, t


# (JAX form, N, H, W, [D,] Cin, Cout, kernel, stride, dilation, groups)
CONV_CASES = {
    "nn_conv_stride2": ("nn", (2, 9, 11), 8, 16, 3, 2, 1, 1),
    "nn_conv_dil18_16rows": ("nn", (1, 16, 20), 8, 8, 3, 1, 18, 1),
    "nn_conv_7x7_cin3": ("nn", (2, 20, 24), 3, 8, 7, 2, 1, 1),
    "nn_conv_grouped": ("nn", (2, 9, 9), 8, 8, 3, 2, 1, 2),
    "nn_conv_1x1": ("nn", (2, 5, 6), 16, 8, 1, 1, 1, 1),
    "zslab_s1": ("zslab", (1, 6, 5, 4), 4, 6, 3, 1, 1, 1),
    "zslab_s2": ("zslab", (1, 6, 6, 4), 4, 6, 3, 2, 1, 1),
    "zfold_s1": ("zfold", (1, 6, 5, 4), 4, 6, 3, 1, 1, 1),
    "zfold_s2": ("zfold", (1, 6, 6, 5), 4, 6, 3, 2, 1, 1),
    "pointwise_s1": ("pointwise", (1, 6, 5, 4), 8, 4, 1, 1, 1, 1),
    "pointwise_s2": ("pointwise", (1, 6, 6, 4), 8, 4, 1, 2, 1, 1),
}


def _jax_form(form, cout, k, stride, dil, groups):
    """JAX's int8 function of ``form`` for a module of these attributes."""
    if form == "nn":
        m = fnn.Conv(cout, (k, k), strides=(stride, stride),
                     padding=[(dil * (k // 2),) * 2] * 2,
                     kernel_dilation=(dil, dil), feature_group_count=groups)
        return lambda qp, x: JQ._quant_nn_conv(m, qp, x)
    if form == "zslab":
        m = Conv3DZSlab(cout, strides=stride)
        return lambda qp, x: JQ._quant_zslab(m, qp, x)
    if form == "zfold":
        m = Conv3DZFold(cout, strides=stride)
        return lambda qp, x: JQ._quant_zfold(m, qp, x)
    m = Conv1x1x1Dense(cout, strides=stride)
    return lambda qp, x: JQ._quant_pointwise(m, qp, x)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_plain_int8_conv_matches_jax_forms(case):
    form, sp, cin, cout, k, stride, dil, groups = CONV_CASES[case]
    rng = np.random.RandomState(len(case))
    nd = len(sp) - 1
    ks = (k,) * nd
    w_q = rng.randint(-127, 128, (cout, cin // groups) + ks).astype(np.int8)
    jfn = _jax_form(form, cout, k, stride, dil, groups)
    pad = dil * (k // 2)
    # the sums: integer inputs at unit scales
    xi = rng.randint(-127, 128, (sp[0], cin) + sp[1:]).astype(np.float32)
    j, t = _qp(w_q, 1.0, np.ones(cout, np.float32))
    x_j = np.moveaxis(xi, 1, -1)
    want = np.asarray(jfn(j, jnp.asarray(x_j)))
    y, acc = conv_s8.conv_s8(torch.from_numpy(xi), t, stride, pad, dil,
                             groups, return_sums=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(np.moveaxis(acc.numpy(), 1, -1),
                                  want.astype(np.int64), err_msg=case)
    # the outputs: float inputs at real scales, per-tensor and per-channel
    x = (rng.randn(sp[0], cin, *sp[1:]) * 2.0).astype(np.float32)
    s_w = (rng.rand(cout) * 0.01 + 0.001).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    m_xs = [None] if groups > 1 else [None, (rng.rand(cin) * 40 + 20)
                                      .astype(np.float32)]
    for m_x in m_xs:
        j, t = _qp(w_q, 0.05, s_w, b, m_x)
        want = np.asarray(jfn(j, jnp.asarray(np.moveaxis(x, 1, -1))))
        got = conv_s8.conv_s8(torch.from_numpy(x), t, stride, pad, dil,
                              groups)
        got = np.moveaxis(got.numpy(), 1, -1)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), case


def test_int8_refuses_autograd():
    w = torch.ones(4, 4, 1, 1, dtype=torch.int8)
    _, t = _qp(w.numpy(), 0.1, np.ones(4, np.float32))
    x = torch.randn(1, 4, 3, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        conv_s8.conv_s8(x, t, 1, 0, 1, 1)


def test_pack_weight_layout():
    """(G, taps, Npad, Cpad): a tap's (n, c) slab K-major, zero past
    Cout / G and C / G, both padded to 16."""
    w = torch.randint(-127, 128, (6, 3, 2, 3), dtype=torch.int8)
    pk = conv_s8.pack_weight(w, 2)
    assert pk.shape == (2, 6, 16, 16) and pk.is_contiguous()
    for g, n, tap, c in [(0, 0, 0, 0), (1, 2, 5, 2), (1, 1, 3, 1)]:
        assert pk[g, tap, n, c] == w[g * 3 + n, c, tap // 3, tap % 3]
    assert not pk[:, :, 3:].any() and not pk[:, :, :, 3:].any()
    w3 = torch.randint(-127, 128, (20, 40, 3, 3, 3), dtype=torch.int8)
    pk3 = conv_s8.pack_weight(w3, 1)
    assert pk3.shape == (1, 27, 32, 48)
    assert torch.equal(pk3[0, :, :20, :40],
                       w3.reshape(20, 40, 27).permute(2, 0, 1))


# (x shape, w shape, stride, padding, dilation, groups): the depth net's
# dilation 18 and 6 at 16 rows, the 7x7 stem, grouped, 3D s2, 1x1x1 s2
S8_COUNTS = {
    "dil18_16rows": ((1, 8, 16, 44), (8, 8, 3, 3), 1, 18, 18, 1),
    "dil6_16rows": ((2, 6, 16, 44), (4, 6, 3, 3), 1, 6, 6, 1),
    "stem_7x7_s2": ((1, 3, 25, 31), (4, 3, 7, 7), 2, 3, 1, 1),
    "grouped_s2": ((1, 8, 9, 9), (8, 4, 3, 3), 2, 1, 1, 2),
    "conv3d_s2": ((1, 4, 6, 5, 4), (6, 4, 3, 3, 3), 2, 1, 1, 1),
    "pointwise_s2": ((1, 4, 6, 5, 4), (6, 4, 1, 1, 1), 2, 0, 1, 1),
}


@pytest.mark.parametrize("case", sorted(S8_COUNTS))
def test_s8_bound_counts_in_map_products(case):
    """``chip_smoke.s8_products`` (the int8 conv's bound) counts the
    products whose input lies on the map: the sum of a conv of ones."""
    import chip_smoke
    xs, ws, st, pd, dl, g = S8_COUNTS[case]
    conv = (torch.nn.functional.conv2d if len(xs) == 4
            else torch.nn.functional.conv3d)
    y = conv(torch.ones(xs, dtype=torch.float64),
             torch.ones(ws, dtype=torch.float64), None, st, pd, dl, g)
    assert chip_smoke.s8_products(xs, ws, y.shape, st, pd, dl) == int(
        y.sum())


# --------------------------------------------------------------------------
# the kernel's design on the CPU: quantize pass, plan, live taps, split-K


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_pass_layout_and_rounding(layout, per_channel):
    """The quantize pass's plain version: (N, D, H, W, Cp) int8, Cp = C
    rounded up to 16, zeros in the padding, :func:`quantize_plain`'s values
    whatever x's memory layout; half-way values round to even."""
    rng = np.random.RandomState(4)
    s_x = torch.tensor(np.float32(0.5))
    m_x = (torch.from_numpy((rng.rand(19) + 0.5).astype(np.float32))
           if per_channel else None)
    x = torch.from_numpy(rng.randn(2, 19, 5, 7).astype(np.float32) * 20)
    if m_x is not None:
        m_x[:3] = 2.0
    # x / s_x (or x * m_x) exactly 2.5, -3.5, 0.5: round to 2, -4, 0
    for c, v in ((0, 2.5), (1, -3.5), (2, 0.5)):
        x[0, c, 1, 2] = v / 2
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    q = conv_s8.quantize_cl_plain(x, m_x, s_x)
    assert q.shape == (2, 1, 5, 7, 32) and q.dtype == torch.int8
    want = conv_s8.quantize_plain(x, m_x, s_x)
    assert torch.equal(q[:, 0, :, :, :19], want.permute(0, 2, 3, 1))
    assert not q[..., 19:].any()
    assert [int(q[0, 0, 1, 2, c]) for c in range(3)] == [2, -4, 0]
    assert int(q.max()) <= 127 and int(q.min()) >= -127
    x3 = torch.randn(1, 5, 3, 4, 6)
    q3 = conv_s8.quantize_cl_plain(x3, None, s_x)
    assert q3.shape == (1, 3, 4, 6, 16)
    assert torch.equal(q3[..., :5], conv_s8.quantize_plain(
        x3, None, s_x).permute(0, 2, 3, 4, 1))


def _box(xq, cv, p, n, od0, oh0, ow0, m0, tap, c, width):
    """The kernel's A box of tap ``tap`` at channel ``c``: (BM, width)
    int64 rows in box order, zero where TMA zero-fills (off the map,
    channels past Cp) and past the box."""
    N, D, H, W, Cp = xq.shape
    a = torch.zeros(p.BM, width, dtype=torch.int64)
    cols = [c + j for j in range(width) if c + j < Cp]
    if p.flat:
        rows = torch.arange(m0, min(m0 + p.BM, N * D * H * W))
        a[:len(rows), :len(cols)] = xq.reshape(-1, Cp)[rows][:, cols]
        return a
    kd, kh, kw = tap // (cv.KH * cv.KW), tap // cv.KW % cv.KH, tap % cv.KW
    for r in range(p.TD * p.TY * p.TX):
        td, ty, tx = r // (p.TY * p.TX), r // p.TX % p.TY, r % p.TX
        i_d = (od0 + td) * cv.sd - cv.pd + kd * cv.dd
        i_h = (oh0 + ty) * cv.sh - cv.ph + kh * cv.dh
        i_w = (ow0 + tx) * cv.sw - cv.pw + kw * cv.dw
        if 0 <= i_d < D and 0 <= i_h < H and 0 <= i_w < W:
            a[r, :len(cols)] = xq[n, i_d, i_h, i_w, cols]
    return a


def _weights(wk, grp, tap, n0, BN, c, width):
    """The kernel's B box: (BN, width) of the packed weights, zero past
    them (a tap index past the last is all zeros)."""
    G, T, Npad, Cpad = wk.shape
    b = torch.zeros(BN, width, dtype=torch.int64)
    if tap < T:
        blk = wk[grp, tap, n0:n0 + BN, c:c + width]
        b[:blk.shape[0], :blk.shape[1]] = blk
    return b


def emulate_sums(x, qp, stride, padding, dilation, groups, plan=None):
    """The kernel's int32 sums by its decomposition: the space-to-depth
    form where ``s2d_geometry`` gives one, ``plan_s8``'s tiles, each
    tile's live taps, K steps of one A box and one B box (two of each a
    step at BK = 16, the odd last tap's partner zero weights), split S
    ways into int32 partials that a second pass sums."""
    cv0 = conv_s8.conv_geometry(tuple(x.shape), tuple(qp["w_q"].shape),
                                stride, padding, dilation, groups)
    cv = conv_s8.s2d_geometry(cv0) or cv0
    p = plan or conv_s8.plan_s8(cv)
    if cv is cv0:
        xq = conv_s8.quantize_cl_plain(x, qp["m_x"], qp["s_x"]).long()
        wk = conv_s8.pack_weight(qp["w_q"], groups).long()
    else:
        xq = conv_s8.quantize_s2d_plain(x, qp["m_x"], qp["s_x"], cv0).long()
        wk = conv_s8.pack_weight(conv_s8.s2d_weight(qp["w_q"]), 1).long()
    T = cv.KD * cv.KH * cv.KW
    M = cv.N * cv.Do * cv.Ho * cv.Wo
    parts = torch.zeros(p.S, M, cv.Co, dtype=torch.int64)
    n_tiles = p.tiles_x if p.flat else cv.N * p.tiles_d * p.tiles_y * \
        p.tiles_x
    chunks = 1 if p.BK == 16 else -(-cv.Cg // p.BK)
    for mt in range(n_tiles):
        n, od0, oh0, ow0 = conv_s8.tile_origin(cv, p, mt)
        m0 = ow0 if p.flat else 0
        taps = conv_s8.live_taps(cv, p, mt)
        steps = conv_s8.k_steps(cv, p.BK, len(taps))
        rows = []
        for r in range(p.BM):
            if p.flat:
                rows.append(m0 + r if m0 + r < M else -1)
                continue
            td, ty, tx = r // (p.TY * p.TX), r // p.TX % p.TY, r % p.TX
            od, oh, ow = od0 + td, oh0 + ty, ow0 + tx
            ok = (r < p.TD * p.TY * p.TX and od < cv.Do and oh < cv.Ho
                  and ow < cv.Wo)
            rows.append(((n * cv.Do + od) * cv.Ho + oh) * cv.Wo + ow
                        if ok else -1)
        keep = torch.tensor([r for r in range(p.BM) if rows[r] >= 0])
        dest = torch.tensor([rows[r] for r in keep.tolist()])
        for grp in range(cv.G):
            for nt in range(p.tiles_n):
                n0 = nt * p.BN
                for split in range(p.S):
                    s0, s1 = conv_s8.split_range(steps, p.S, split)
                    acc = torch.zeros(p.BM, p.BN, dtype=torch.int64)
                    for step in range(s0, s1):
                        if p.BK == 16:
                            t0 = taps[2 * step]
                            two = 2 * step + 1 < len(taps)
                            t1 = taps[2 * step + 1] if two else t0
                            loads = [(t0, t0, 0), (t1, t1 if two else T, 0)]
                            width = 16
                        else:
                            t = taps[step // chunks]
                            loads = [(t, t, step % chunks * p.BK)]
                            width = p.BK
                        for ta, tb, c0 in loads:
                            a = _box(xq, cv, p, n, od0, oh0, ow0, m0, ta,
                                     grp * cv.Cg + c0, width)
                            b = _weights(wk, grp, tb, n0, p.BN, c0, width)
                            acc += (a.double() @ b.double().t()).long()
                    ncols = min(p.BN, cv.Ng - n0)
                    if len(keep):
                        o0 = grp * cv.Ng + n0
                        parts[split, dest, o0:o0 + ncols] = \
                            acc[keep, :ncols]
    for part in parts:
        assert part.abs().max() < 2 ** 31  # int32 partials
    s = parts.sum(0).reshape(cv.N, cv.Do, cv.Ho, cv.Wo, cv.Co)
    s = s.permute(0, 4, 1, 2, 3)
    return (s[:, :, 0] if x.dim() == 4 else s).to(torch.int32)


# (x shape, Cout, kernel, stride, padding, dilation, groups, per-channel):
# each class the kernel takes, at small N
EMU_CASES = {
    "dil18_16rows": ((1, 40, 16, 44), 24, 3, 1, 18, 18, 1, True),
    "dil12_16rows": ((1, 40, 16, 44), 24, 3, 1, 12, 12, 1, True),
    "splitk_8x22_3x3": ((1, 160, 8, 22), 32, 3, 1, 1, 1, 1, True),
    "splitk_8x22_1x1": ((1, 288, 8, 22), 80, 1, 1, 0, 1, 1, True),
    "stride2_3x3": ((1, 24, 11, 13), 16, 3, 2, 1, 1, 1, False),
    "stride2_1x1": ((1, 24, 11, 13), 32, 1, 2, 0, 1, 1, True),
    "stem_7x7_s2": ((1, 3, 20, 26), 16, 7, 2, 3, 1, 1, True),
    "conv3d_s1": ((1, 24, 5, 5, 2), 16, 3, 1, 1, 1, 1, True),
    "conv3d_s2_1x1x1": ((1, 24, 6, 5, 4), 16, 1, 2, 0, 1, 1, False),
    "grouped": ((1, 64, 9, 9), 32, 3, 2, 1, 1, 2, False),
    "grouped_narrow": ((1, 24, 7, 7), 24, 3, 1, 1, 1, 2, False),
    "pooled_m6": ((6, 96, 1, 1), 40, 1, 1, 0, 1, 1, True),
}


def _emu_inputs(case):
    shape, cout, k, st, pd, dl, g, per_channel = EMU_CASES[case]
    rng = np.random.RandomState(len(case) + 100)
    ks = (k,) * (len(shape) - 2)
    qp = {"w_q": torch.from_numpy(rng.randint(-127, 128, (
              cout, shape[1] // g) + ks).astype(np.int8)),
          "s_x": torch.tensor(np.float32(0.03)),
          "m_x": (torch.from_numpy((rng.rand(shape[1]) * 40 + 20).astype(
              np.float32)) if per_channel else None)}
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3)
    return x, qp, (st, pd, dl, g)


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_kernel_decomposition_equals_sums(case):
    """The kernel's decomposition (:func:`emulate_sums`) under its own plan
    and under plans forced to split K, held ``torch.equal`` to the plain
    sums: TMA boxes with zero fill and strides, skipped taps, the stem's
    two taps a step, group offsets, flat tiles, int32 split-K partials."""
    x, qp, args = _emu_inputs(case)
    want = conv_s8.sums_plain(conv_s8.quantize_plain(x, qp["m_x"],
                                                     qp["s_x"]),
                              qp["w_q"], *args)
    cv = conv_s8.conv_geometry(tuple(x.shape), tuple(qp["w_q"].shape),
                               *args)
    cv = conv_s8.s2d_geometry(cv) or cv
    p = conv_s8.plan_s8(cv)
    assert torch.equal(emulate_sums(x, qp, *args, plan=p), want)
    steps = conv_s8.k_steps(cv, p.BK, len(conv_s8.live_taps(cv, p, 0)))
    for S in (3, steps + 2):  # splits with empty ranges write zeros
        assert torch.equal(emulate_sums(x, qp, *args, plan=p._replace(S=S)),
                           want), S


def test_plan_s8_at_flagship_shapes():
    """The plans of the classes the flagship gives the kernel: flat 1x1s,
    the stem's two taps a step, split K among the candidates where the
    grid is small, and every plan within the kernel's limits."""
    shapes = {  # x, w, stride, padding, dilation, groups
        "stem": ((6, 3, 256, 704), (64, 3, 7, 7), 2, 3, 1, 1),
        "l1_1x1": ((6, 64, 64, 176), (64, 64, 1, 1), 1, 0, 1, 1),
        "l2_3x3_s2": ((6, 128, 64, 176), (128, 128, 3, 3), 2, 1, 1, 1),
        "l3_3x3": ((6, 256, 16, 44), (256, 256, 3, 3), 1, 1, 1, 1),
        "aspp_d18": ((6, 512, 16, 44), (512, 512, 3, 3), 1, 18, 18, 1),
        "neck_2560": ((6, 2560, 16, 44), (512, 2560, 1, 1), 1, 0, 1, 1),
        "l4_1x1": ((6, 2048, 8, 22), (512, 2048, 1, 1), 1, 0, 1, 1),
        "l4_3x3": ((6, 512, 8, 22), (512, 512, 3, 3), 1, 1, 1, 1),
        "pooled": ((6, 512, 1, 1), (256, 512, 1, 1), 1, 0, 1, 1),
        "bev_25x25x2": ((1, 256, 25, 25, 2), (256, 256, 3, 3, 3), 1, 1, 1,
                        1),
        "vov_160": ((6, 160, 64, 176), (160, 160, 3, 3), 1, 1, 1, 1),
    }
    plans = {}
    for name, (xs, ws, *args) in shapes.items():
        cv = conv_s8.conv_geometry(xs, ws, *args)
        p = plans[name] = conv_s8.plan_s8(cv)
        stage = conv_s8.ring(p.BM, p.BN, p.BK)[0]
        assert 2 <= p.stages <= conv_s8.MAX_STAGES
        assert conv_s8.smem_bytes(p.BM, stage, p.stages) <= 227 * 1024 - 4096
        assert p.stages * stage >= p.BM // 64 * conv_s8.EPI_BYTES
        if not p.flat:
            assert p.TD * p.TY * p.TX <= p.BM
            assert max(p.TX * cv.sw, p.TY * cv.sh, p.TD * cv.sd) <= 256
        assert p.flat == conv_s8.is_flat(cv)
    assert plans["stem"].BK == 16 and plans["pooled"].flat
    stem = conv_s8.s2d_geometry(conv_s8.conv_geometry(*shapes["stem"][:2],
                                                      *shapes["stem"][2:]))
    assert (stem.C, stem.KH, stem.KW, stem.sh, stem.ph, stem.H, stem.W) == (
        12, 4, 4, 1, 0, 131, 355)
    assert conv_s8.plan_s8(stem).BK == 16
    for name in ("l4_3x3", "bev_25x25x2", "pooled"):  # small grids: split
        xs, ws, *args = shapes[name]                   # K is considered
        assert any(p.S > 1 for _, p in conv_s8.plans_s8(
            conv_s8.conv_geometry(xs, ws, *args)))


# (x shape, Cout, kernel, padding): stride-2 convs of <= 4 channels
S2D_CASES = {"stem_7x7_p3": ((2, 3, 20, 26), 8, 7, 3),
             "3x3_p1_odd": ((1, 3, 11, 13), 5, 3, 1),
             "4x4_p1_c2": ((1, 2, 9, 10), 4, 4, 1),
             "1x1_c4": ((1, 4, 8, 8), 3, 1, 0)}


@pytest.mark.parametrize("case", sorted(S2D_CASES))
def test_space_to_depth_form_equals_sums(case):
    """A stride-2 conv of <= 4 channels as its space-to-depth form: the
    stride-1 conv of ``s2d_weight`` on ``quantize_s2d_plain``'s input takes
    the same int32 sums."""
    shape, cout, k, pd = S2D_CASES[case]
    rng = np.random.RandomState(len(case))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3)
    w = torch.from_numpy(rng.randint(-127, 128, (cout, shape[1], k, k))
                         .astype(np.int8))
    s_x = torch.tensor(np.float32(0.03))
    cv = conv_s8.conv_geometry(shape, tuple(w.shape), 2, pd, 1, 1)
    g = conv_s8.s2d_geometry(cv)
    assert (g.sh, g.sw, g.ph, g.pw, g.KH) == (1, 1, 0, 0, -(-k // 2))
    xs = conv_s8.quantize_s2d_plain(x, None, s_x, cv)
    assert xs.shape == (shape[0], 1, g.H, g.W, 16)
    assert not xs[..., 4 * shape[1]:].any()
    got = conv_s8.sums_plain(xs[:, 0, ..., :4 * shape[1]].permute(
        0, 3, 1, 2), conv_s8.s2d_weight(w), 1, 0, 1, 1)
    want = conv_s8.sums_plain(conv_s8.quantize_plain(x, None, s_x), w, 2,
                              pd, 1, 1)
    assert torch.equal(got, want)


# (x shape, w shape, stride, padding, dilation): the live-tap classes
LIVE_CASES = {
    "dil18_16rows": ((1, 8, 16, 44), (8, 8, 3, 3), 1, 18, 18),
    "dil12_16rows": ((2, 8, 16, 44), (8, 8, 3, 3), 1, 12, 12),
    "dil6_16rows": ((1, 8, 16, 44), (8, 8, 3, 3), 1, 6, 6),
    "stem_7x7_s2": ((1, 3, 25, 31), (16, 3, 7, 7), 2, 3, 1),
    "stride2_one_pixel": ((1, 8, 1, 1), (8, 8, 3, 3), 2, 2, 1),
    "conv3d_s2": ((1, 8, 6, 5, 4), (8, 8, 3, 3, 3), 2, 1, 1),
}


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_skipped_taps_are_the_off_map_ones(case):
    """A tile skips exactly the taps with no in-map (tap, output pixel)
    pair among its pixels, counted by ``chip_smoke.s8_products`` on the
    tile's outputs and the one tap."""
    import chip_smoke
    xs, ws, st, pd, dl = LIVE_CASES[case]
    cv = conv_s8.conv_geometry(xs, ws, st, pd, dl, 1)
    p = conv_s8.plan_s8(cv)
    n = len(xs) - 2
    ks, sts = (cv.KD, cv.KH, cv.KW), (cv.sd, cv.sh, cv.sw)
    pds, dls = (cv.pd, cv.ph, cv.pw), (cv.dd, cv.dh, cv.dw)
    outs, box = (cv.Do, cv.Ho, cv.Wo), (p.TD, p.TY, p.TX)
    skipped = 0
    for mt in range(cv.N * p.tiles_d * p.tiles_y * p.tiles_x):
        origin = conv_s8.tile_origin(cv, p, mt)[1:]
        cnt = [min(o + b, O) - o for o, b, O in zip(origin, box, outs)]
        live = set(conv_s8.live_taps(cv, p, mt))
        for t in range(cv.KD * cv.KH * cv.KW):
            k = (t // (cv.KH * cv.KW), t // cv.KW % cv.KH, t % cv.KW)
            pad = [pds[i] - origin[i] * sts[i] - k[i] * dls[i]
                   for i in range(3)]
            pairs = chip_smoke.s8_products(
                (1, 1) + tuple(xs[2:]), (1, 1) + (1,) * n,
                (1, 1) + tuple(cnt[3 - n:]), sts[3 - n:], pad[3 - n:],
                (1,) * n)
            assert (t in live) == (pairs > 0), (mt, t)
            skipped += t not in live
    if case == "dil18_16rows":
        assert skipped >= 6 * (cv.N * p.tiles_d * p.tiles_y * p.tiles_x) // 2


# --------------------------------------------------------------------------
# the slice

def test_tiny_pipeline_int8_matches_jax(monkeypatch):
    """The small FB-OCC of ``test_torch_slice.py`` in float32, the same
    weights on both sides, ``enable_int8`` on two frames on both: the
    same convs quantized under the name map (the depth net's basic blocks
    and ASPP among them, its final 1x1 conv and the BEV side not), labels
    of a 4-frame stream agreeing, and each quantized conv run in int8
    once a frame."""
    from fbbev_tpu.models import FBOCC as JaxFBOCC
    from fbbev_tpu.serving import FixedRigPipeline as JaxPipeline
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.serving import FixedRigPipeline
    from fbbev_tpu_torch.weights import conv_paths, load_jax_variables
    from tests.test_torch_slice import SMALL, flow, jax_cam, rig, torch_cam
    from tests.test_torch_switches import jax_variables

    for k in ("FBBEV_INT8_ACT_STAT", "FBBEV_INT8_CALIB", "FBBEV_INT8_BEV",
              "FBBEV_INT8_SMOOTH_ALPHA", "FBBEV_INT8_EXCLUDE_EXTRA"):
        monkeypatch.delenv(k, raising=False)
    jm = JaxFBOCC(**SMALL)
    v = jax_variables(jm, seed=11)
    tm = load_jax_variables(FBOCC(**SMALL, device="cpu"), v)
    cam = rig()
    jp = JaxPipeline(jm, v, jax_cam(cam))
    tp = FixedRigPipeline(tm, torch_cam(cam))
    rng = np.random.RandomState(5)
    imgs = [rng.randn(1, 2, 64, 128, 3).astype(np.float32) for _ in range(4)]
    jmetas = [dict(start_of_sequence=jnp.full((1,), i == 0),
                   sequence_group_idx=jnp.zeros((1,), jnp.int32),
                   curr_to_prev_ego_rt=jnp.asarray(flow(i)))
              for i in range(2)]
    want_q = jp.enable_int8(imgs[:2], jmetas)
    got_q = tp.enable_int8(imgs[:2], [dict(start_of_sequence=i == 0,
                                           curr_to_prev_ego_rt=flow(i))
                                      for i in range(2)])
    paths = conv_paths(tm)
    assert sorted(paths[k] for k in got_q) == sorted(want_q)
    assert sorted(paths[k] for k in tp._int8_scales) == sorted(
        jp._int8_scales)
    assert len(want_q) == len(jp._int8_scales) - 29  # 2 heads + BEV side
    for p in ["depth_net/depth_block0/conv1/conv", "depth_net/aspp/aspp4/conv",
              "depth_net/aspp/gap/conv", "depth_net/aspp/proj/conv"]:
        assert p in want_q
    assert "depth_net/depth_conv" not in want_q
    assert not any("img_bev_encoder" in paths[k] or "occupancy_head"
                   in paths[k] for k in got_q)

    real, calls = conv_s8.conv_s8_plain, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(conv_s8, "conv_s8_plain", counted)
    agree = []
    for i, im in enumerate(imgs):
        start = i in (0, 3)
        rt = flow(0 if start else i)
        want = np.asarray(jp(im, start, rt))
        got = tp(im, start, rt).numpy()
        assert got.shape == want.shape
        agree.append(float((got == want).mean()))
    assert len(calls) == 4 * len(got_q)
    assert min(agree) >= 0.99, agree


def test_calibration_leaves_the_state():
    from fbbev_tpu_torch.models import FBOCC
    from fbbev_tpu_torch.serving import FixedRigPipeline
    from tests.test_torch_slice import SMALL, flow, rig, torch_cam
    pipe = FixedRigPipeline(FBOCC(**SMALL, device="cpu"), torch_cam(rig()))
    rng = np.random.RandomState(0)
    pipe(rng.randn(1, 2, 64, 128, 3).astype(np.float32), True)
    before = [t.clone() for t in pipe.state]
    pipe.enable_int8([rng.randn(1, 2, 64, 128, 3).astype(np.float32)],
                     [dict(start_of_sequence=False,
                           curr_to_prev_ego_rt=flow(1))])
    assert all(torch.equal(a, b) for a, b in zip(before, pipe.state))
    with pytest.raises(ValueError, match="float32"):
        Q.build_qparams(pipe.model.to(torch.bfloat16), pipe._int8_scales)


# --------------------------------------------------------------------------
# the tools

def test_serving_bench_int8_scales_cached(tmp_path, monkeypatch):
    """A scales file under the tool's key is read back: the tool serves
    int8 on those scales (each of their convs once a frame) and does not
    calibrate again."""
    from fbbev_tpu_torch.config import Config
    from fbbev_tpu_torch.serving import FixedRigPipeline
    from fbbev_tpu_torch.tools import serving_bench
    from fbbev_tpu_torch.utils.fuse_bn import build_folded
    cfg = Config.fromfile(TINY)
    seed = int(cfg.get("seed", 0))
    model = build_folded(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    N, (H, W) = model.num_cams, model.input_size
    pipe = FixedRigPipeline(model, serving_bench.fixed_rig(N, H, W, 1))
    im, rt = serving_bench.frame(0, 1, N, H, W, "cpu")
    n_q = len(pipe.enable_int8([im], [dict(start_of_sequence=True,
                                           curr_to_prev_ego_rt=rt)]))
    key = Q.code_cache_key("fbocc-r50-tiny_synthetic", (H, W), seed)
    assert key["quantize_sha"] == Q.code_cache_key("", (1, 1), 0)[
        "quantize_sha"]
    path = tmp_path / "scales.json"
    path.write_text(json.dumps({"key": key, "scales": Q.scales_to_json(
        pipe._int8_scales)}))

    def no_calibration(*a, **kw):
        raise AssertionError("calibrated again")

    real, calls = conv_s8.conv_s8_plain, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(FixedRigPipeline, "enable_int8", no_calibration)
    monkeypatch.setattr(conv_s8, "conv_s8_plain", counted)
    line = serving_bench.main([TINY, "--device", "cpu", "--chunk", "4",
                               "--rounds", "1", "--scales", str(path)])
    assert line["int8"] is True
    assert len(calls) == 8 * n_q  # a first round and a timed one


def test_fidelity_small_int8_line(capsys):
    from fbbev_tpu_torch.tools import fidelity
    report = fidelity.main(["--small", "--cpu", "--int8", "--frames", "2",
                            "--bn-warmup", "1", "--dtype", "float32"])
    out = [json.loads(x) for x in capsys.readouterr().out.strip()
           .splitlines()]
    assert out[0] == {"int8_quantized_convs": 37}
    assert [f["frame"] for f in out[1:-1]] == [0, 1]
    assert sorted(out[1]) == sorted([
        "frame", "occ_argmax_agreement_pct", "logit_abs_p99",
        "top1_logit_max_abs", "top1_logit_rms", "depth_max_abs",
        "depth_max_rel_to_peak", "context_max_abs",
        "context_max_rel_to_peak", "bev_refined_max_abs",
        "bev_refined_max_rel_to_peak", "occ_logits_rel_l2",
        "depth_rel_l2", "context_rel_l2", "bev_refined_rel_l2"])
    assert all(0.0 <= out[1][k] < 1.0 for k in out[1] if
               k.endswith("_rel_l2"))
    assert out[-1]["min_agreement_pct"] == report["min_agreement_pct"]
    assert report["int8"] and report["fold_bn"]
    assert report["min_agreement_pct"] > 90.0
