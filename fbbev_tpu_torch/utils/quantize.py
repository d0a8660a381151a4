"""Post-training int8 quantization (PTQ) of the serving convolutions.
Counterpart of ``fbbev_tpu/utils/quantize.py``, with its names, defaults
and arithmetic:

* per-OUTPUT-CHANNEL symmetric weight scales, computed on the host from
  float32 weights;
* per-INPUT-CHANNEL SmoothQuant smoothing: calibration collects a
  per-channel ``|x|`` statistic of each conv's input; a factor ``t_c =
  a_c**alpha / wmax_c**(1-alpha)`` is divided out of the activation and
  multiplied into the weight's input-channel axis before the weights are
  quantized (an exact rewrite of the conv), so that outlier channels stop
  setting the whole tensor's step; ``alpha=0`` or ``per_tensor=True`` is
  the per-tensor scheme;
* a per-TENSOR symmetric scale on the smoothed activation; the statistic
  is the 99.9th percentile of ``|x|`` per channel (``act_stat="p999"``,
  the default) or its maximum (``"absmax"``).

The JAX package's environment switches are keyword arguments here, with
its defaults.  Its flax method interceptors become forward pre-hooks
(calibration, :func:`collect_scales`) and forward overrides (execution,
:func:`set_quantized`, :func:`quantized_calls`) on the eligible modules:
``nn.Conv2d`` and ``nn.Conv3d`` and their subclasses, each only where
its ``forward`` runs
(the SE gates hold 1x1 convs they never call: JAX's are dense layers).
The convs run as :func:`fbbev_tpu_torch.ops.conv_s8.conv_s8`: the plain
version on the CPU, the hand-written kernel on a card.  Parameters are
keyed by the port's module names; the exclusion regexes are JAX's and
are searched in each conv's JAX module path (:func:`weights.conv_paths`:
``depth_net/depth_conv`` is the depth net's final 1x1 conv, not the port's
``depth_net.depth_conv`` Sequential that holds the basic blocks and the
ASPP).  By default the classification heads and the BEV side (3D encoder,
occ head) are left unquantized: the image trunk only, as the JAX serving
default.  int8 serves only: an int8 conv refuses autograd.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import os
import re
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from fbbev_tpu_torch.ops import conv_s8

# the final 19-class occupancy logits and the 80-way pre-softmax depth
# head: the classic PTQ exclusions
DEFAULT_EXCLUDE = (r"pred_conv2", r"depth_net/depth_conv")
# the BEV side (3D encoder + occ head), left out of the JAX serving
# default, which quantizes the image trunk only
BEV_SIDE_EXCLUDE = (r"img_bev_encoder", r"occupancy_head")

P999 = 0.999


def eligible(m: nn.Module) -> bool:
    """Convs the int8 path can take (JAX's ``nn.Conv``, ``Conv3DZSlab``,
    ``Conv3DZFold``, ``Conv1x1x1Dense``)."""
    return isinstance(m, (nn.Conv2d, nn.Conv3d))


def p999(a: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(a, 0.999, axis=1)`` of a (C, n) float32 tensor, with
    its float32 arithmetic: position ``0.999 * (n - 1)`` in float32, the
    two order statistics around it (``kthvalue``: ``torch.quantile``
    refuses more than 2^24 values), ``low * (1 - w) + high * w``."""
    n = a.shape[1]
    f32 = torch.float32
    pos = torch.tensor(P999, dtype=f32) * (torch.tensor(float(n), dtype=f32)
                                           - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1 - w_hi
    lo_i = int(lo.clamp(0, n - 1)) + 1
    hi_i = int(hi.clamp(0, n - 1)) + 1
    low = a.kthvalue(lo_i, dim=1).values
    high = low if hi_i == lo_i else a.kthvalue(hi_i, dim=1).values
    return low * w_lo.to(a.device) + high * w_hi.to(a.device)


def channel_stat(x: torch.Tensor, act_stat: str = "p999") -> torch.Tensor:
    """Per-input-channel statistic of ``|x|`` (channels on axis 1), float32
    on x's device: the 99.9th percentile (``"p999"``) or the maximum
    (``"absmax"``)."""
    a = x.detach().float().abs().transpose(0, 1).reshape(x.shape[1], -1)
    if act_stat == "p999":
        return p999(a)
    if act_stat == "absmax":
        return a.amax(dim=1)
    raise ValueError(f"act_stat {act_stat!r}: 'p999' or 'absmax'")


# ---------------------------------------------------------------------------
# calibration


@contextlib.contextmanager
def collect_scales(model: nn.Module, act_stat: str = "p999"):
    """While active, every eligible conv of ``model`` whose forward runs
    records :func:`channel_stat` of its input, reduced by maximum over its
    calls.  Yields the dict it fills: {module name: (Cin,) float32}."""
    stats: Dict[str, torch.Tensor] = {}
    handles = []

    def hook(name):
        def pre(m, inputs):
            v = channel_stat(inputs[0], act_stat)
            stats[name] = (torch.maximum(stats[name], v) if name in stats
                           else torch.clamp(v, min=0.0))
        return pre

    try:
        for name, m in model.named_modules():
            if eligible(m):
                handles.append(m.register_forward_pre_hook(hook(name)))
        yield stats
    finally:
        for h in handles:
            h.remove()


def scales_from_stats(stats: Dict[str, torch.Tensor]
                      ) -> Dict[str, np.ndarray]:
    """{module name: statistic (Cin,) float64 numpy}."""
    return {k: v.cpu().numpy().astype(np.float64) for k, v in stats.items()}


def _merge_scales(merged: Dict[str, Any], new: Dict[str, Any]) -> None:
    for k, v in new.items():
        merged[k] = np.maximum(merged[k], v) if k in merged else v


def scales_to_json(scales: Dict[str, Any]) -> Dict[str, Any]:
    """Serializable form of a calibration artifact (per-channel vectors
    become lists; legacy scalar entries stay floats)."""
    out = {}
    for k, v in scales.items():
        a = np.asarray(v)
        out[k] = float(a) if a.ndim == 0 else [float(x) for x in a]
    return out


def scales_from_json(obj: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (np.asarray(v, np.float64) if isinstance(v, list)
                else float(v))
            for k, v in obj.items()}


def calibrate_serving(pipe, frames: Sequence, metas: Sequence[dict],
                      act_stat: str = "p999") -> Dict[str, np.ndarray]:
    """Run the serving forward (``pipe._fwd``, its convs unquantized) over
    calibration frames, collecting activation statistics.  ``frames[i]``:
    (B, N, H, W, 3) images; ``metas[i]``: ``start_of_sequence`` and
    optionally ``curr_to_prev_ego_rt``.  The temporal state is a local
    copy: ``pipe.state`` is left as it was."""
    state = type(pipe.state)(*(t.clone() for t in pipe.state))
    merged: Dict[str, Any] = {}
    for imgs, meta in zip(frames, metas):
        with quantized_calls(None, pipe.model), \
                collect_scales(pipe.model, act_stat) as stats:
            _, state = pipe._fwd(torch.as_tensor(imgs).to(pipe.device),
                                 pipe.meta(**meta), state)
        _merge_scales(merged, scales_from_stats(stats))
    return merged


@torch.no_grad()
def calibrate_model(model: nn.Module, stream: Iterable[dict], state,
                    act_stat: str = "p999") -> Dict[str, np.ndarray]:
    """Collect activation statistics over the model's eval forward
    (``model(batch, state)``, its convs unquantized) on one temporal
    stream of batch dicts."""
    merged: Dict[str, Any] = {}
    for b in stream:
        with quantized_calls(None, model), \
                collect_scales(model, act_stat) as stats:
            _, state = model(b, state, train=False)
        _merge_scales(merged, scales_from_stats(stats))
    return merged


# ---------------------------------------------------------------------------
# qparams construction (host side)


def jax_paths(model: nn.Module) -> Dict[str, str]:
    """{conv module name: the path the exclusion regexes search}: the JAX
    module path for an FBOCC (:func:`weights.conv_paths`), else the
    module name with ``/`` for ``.``."""
    from fbbev_tpu_torch.weights import conv_paths
    names = [n for n, m in model.named_modules() if eligible(m)]
    paths = (conv_paths(model) if hasattr(model, "depth_net")
             and hasattr(model, "img_backbone") else {})
    return {n: paths.get(n, n.replace(".", "/")) for n in names}


def float32_weights(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The float32 weights to quantize from: those kept by
    ``fuse_bn.build_folded`` before its cast (``model.float32_state``),
    else the model's own where they are float32."""
    kept = getattr(model, "float32_state", None)
    if kept is not None:
        return kept
    sd = model.state_dict()
    low = [k for k, m in model.named_modules() if eligible(m)
           and m.weight.dtype != torch.float32]
    if low:
        raise ValueError(
            f"int8 weights are quantized from float32 weights, and conv "
            f"{low[0]} is {model.get_submodule(low[0]).weight.dtype}: build "
            f"the model with fuse_bn.build_folded, or set model.float32_state "
            f"(fuse_bn.float32_conv_state) before its cast")
    return sd


def build_qparams(model: nn.Module, scales: Dict[str, Any],
                  exclude: Optional[Sequence[str]] = None,
                  min_absmax: float = 1e-6, alpha: float = 0.5,
                  per_tensor: bool = False
                  ) -> Dict[str, Dict[str, Any]]:
    """Quantize the weights of every calibrated conv per output channel,
    smoothing per-input-channel activation outliers into them first
    (module docstring); JAX's ``build_qparams`` in numpy, in the port's
    weight layout (Cout, Cin/groups, k...).

    ``scales[name]``: a (Cin,) statistic (the calibrators') or a legacy
    scalar (per-tensor).  ``exclude``: regexes over :func:`jax_paths`
    (default ``DEFAULT_EXCLUDE + BEV_SIDE_EXCLUDE``, the image trunk only).
    The weights quantized are :func:`float32_weights`.

    Returns {module name: {"w_q" int8, "s_w" f32 (Cout,), "s_x" f32 (),
    "m_x" f32 (Cin,) | None, "b" f32 (Cout,) | None, "scale" f32 (Cout,)
    = s_x * s_w}} on the module's device; on a card also "w_k", the
    packed weights of the kernel (:func:`conv_s8.pack_weight`).  ``m_x``
    is the fused per-channel quantize multiplier ``1 / (t_c * s_x)``; None
    means the per-tensor path."""
    if exclude is None:
        exclude = tuple(DEFAULT_EXCLUDE) + tuple(BEV_SIDE_EXCLUDE)
    per_tensor = per_tensor or alpha == 0.0
    weights = float32_weights(model)
    paths = jax_paths(model)
    mods = dict(model.named_modules())
    exc = [re.compile(p) for p in exclude]
    out: Dict[str, Dict[str, Any]] = {}
    for name, a in scales.items():
        m = mods.get(name)
        if m is None or not eligible(m):
            continue
        if any(p.search(paths[name]) for p in exc):
            continue
        a = np.asarray(a, np.float64)
        absmax = float(a.max())
        if absmax <= min_absmax:
            continue
        k = np.asarray(torch.as_tensor(weights[name + ".weight"]).cpu(),
                       np.float32)
        cin_axes = (1,) + (1,) * (k.ndim - 2)
        m_x = None
        # smoothing needs the full per-input-channel picture: skip for
        # legacy scalar artifacts and for grouped kernels (kernel input
        # dim != Cin, so the fold has no 1:1 channel map)
        if (not per_tensor and a.ndim == 1 and k.ndim >= 2
                and k.shape[1] == a.shape[0]):
            wmax = np.abs(k).max(axis=tuple(i for i in range(k.ndim)
                                            if i != 1))
            live = (a > min_absmax) & (wmax > 1e-12)
            t = np.ones_like(a)
            t[live] = (a[live] ** alpha) / (wmax[live] ** (1.0 - alpha))
            t = np.clip(t, 1e-5, 1e5)
            k = k * t.astype(np.float32).reshape((1, -1) + cin_axes[1:])
            s_x = float((a / t).max()) / 127.0
            m_x = (1.0 / (t * s_x)).astype(np.float32)
        else:
            s_x = absmax / 127.0
        s_w = np.abs(k).max(axis=tuple(range(1, k.ndim))) / 127.0
        s_w = np.maximum(s_w, 1e-12)
        w_q = np.clip(np.round(k / s_w.reshape((-1,) + cin_axes)),
                      -127, 127).astype(np.int8)
        s_x = np.float32(s_x)
        b = (np.asarray(torch.as_tensor(weights[name + ".bias"]).cpu(),
                        np.float32) if m.bias is not None else None)
        dev = m.weight.device

        def t_(v):
            return None if v is None else torch.from_numpy(
                np.ascontiguousarray(v)).to(dev)

        qp = {"w_q": t_(w_q), "s_w": t_(s_w.astype(np.float32)),
              "s_x": t_(np.asarray(s_x)), "m_x": t_(m_x), "b": t_(b),
              "scale": t_((s_x * s_w).astype(np.float32))}
        if dev.type == "cuda":
            qp["w_k"] = conv_s8.pack_weight(qp["w_q"], m.groups)
        out[name] = qp
    return out


def code_cache_key(model_size, input_size, seed: int,
                   act_stat: str = "p999") -> dict:
    """Key of a cached activation-scale artifact: the scales hold only for
    the model config, calibration seed, statistic and quantization code
    that produced them (this file's hash)."""
    path = os.path.abspath(__file__)
    if path.endswith(".pyc"):
        path = path[:-1]
    with open(path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()[:16]
    return {"model": str(model_size), "input": list(input_size),
            "seed": int(seed), "quantize_sha": sha, "act_stat": act_stat}


# ---------------------------------------------------------------------------
# quantized execution


def quant_conv(m: nn.Module, qp: Dict[str, Any], x: torch.Tensor):
    """The int8 form of conv module ``m`` on x (JAX's ``_quant_nn_conv``,
    and for 3D convs its ``_quant_zslab`` / ``_quant_zfold`` /
    ``_quant_pointwise``, which take the same sums)."""
    if m.padding_mode != "zeros" or isinstance(m.padding, str):
        raise NotImplementedError(
            f"int8 conv: padding {m.padding!r} ({m.padding_mode})")
    # x uncast, as JAX quantizes a flax conv's input; the result in the
    # conv's type (``_out_dtype``)
    return conv_s8.conv_s8(x, qp, m.stride, m.padding, m.dilation,
                           m.groups).to(m.weight.dtype)


def set_quantized(model: nn.Module,
                  qparams: Optional[Dict[str, Dict[str, Any]]]) -> None:
    """From now on each conv of ``model`` named in ``qparams`` runs its
    int8 form (:func:`quant_conv`) in place of its own ``forward``; the
    convs an earlier call swapped go back to their own first.  None or
    ``{}``: every conv runs its own ``forward``."""
    mods = dict(model.named_modules())
    for m in mods.values():
        if "_int8_qp" in m.__dict__:
            del m.forward, m._int8_qp
    for name, qp in (qparams or {}).items():
        m = mods[name]
        m._int8_qp = qp
        m.forward = functools.partial(quant_conv, m, qp)


@contextlib.contextmanager
def quantized_calls(qparams: Optional[Dict[str, Dict[str, Any]]],
                    model: nn.Module):
    """While active, the convs of ``model`` run as :func:`set_quantized`
    sets them for ``qparams``; on exit, as they ran before."""
    before = {n: m._int8_qp for n, m in model.named_modules()
              if "_int8_qp" in m.__dict__}
    set_quantized(model, qparams)
    try:
        yield
    finally:
        set_quantized(model, before)
