"""Inference-time Conv+BN folding.  Counterpart of
``fbbev_tpu/utils/fuse_bn.py::fold_batch_norms``, folding exactly the
pairs that one folds, in the same way.

The JAX fold folds every ``{conv: {kernel[, bias]}, bn: ...}`` subtree of
the variables; the port's modules standing for those subtrees are the
(conv, BatchNorm) pairs of :func:`weights.conv_bn_pairs`.  With
``s = scale / sqrt(var + eps)`` each conv becomes ``k' = k * s`` (per
output channel) and ``b' = b * s``, and its BatchNorm is kept, as an
affine map of the folded bias: scale 1, bias ``bias - mean * s``, mean 0,
variance ``1 - eps``.  Every module keeps its structure and parameters:
K1's epilogue and the channels-last time / cat convs read their
BatchNorm's statistics directly, and the conv subclasses of K6 and K7
take no bias.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from fbbev_tpu_torch.weights import conv_bn_pairs


@torch.no_grad()
def fold_batch_norms(model: torch.nn.Module,
                     eps: float = 1e-5) -> List[Tuple[str, str]]:
    """Fold ``model``'s conv / BatchNorm pairs in place; returns them.

    The fold is computed in float32 and written back in each tensor's own
    dtype, so fold a float32 model and cast it after, as the JAX package
    folds its float32 parameters and computes in bf16 from them.  In a
    bf16 model the folded variance ``1 - eps`` rounds to 1.0: its
    BatchNorm then scales by ``1 / sqrt(1 + eps)`` = 1 - 5e-6, under
    bf16's resolution of 2^-8."""
    pairs = conv_bn_pairs(model)
    mods = dict(model.named_modules())
    for conv_name, bn_name in pairs:
        conv, bn = mods[conv_name], mods[bn_name]
        # the float32 square root correctly rounded, as numpy's: through
        # float64 (PyTorch's float32 sqrt on the CPU is off by an ulp at
        # times)
        root = torch.sqrt((bn.running_var.float() + eps).double()).float()
        s = bn.weight.float() / root
        shape = (-1,) + (1,) * (conv.weight.dim() - 1)
        conv.weight.copy_(conv.weight.float() * s.reshape(shape))
        if conv.bias is not None:
            conv.bias.copy_(conv.bias.float() * s)
        bn.bias.copy_(bn.bias.float() - bn.running_mean.float() * s)
        bn.weight.fill_(1.0)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - eps)
    return pairs


@torch.no_grad()
def perturb_batch_norms(model: torch.nn.Module,
                        generator: torch.Generator) -> None:
    """Draws every BatchNorm's ``running_mean`` (N(0, 0.1)),
    ``running_var`` (U(0.5, 1.5)), ``weight`` (U(0.75, 1.25)) and ``bias``
    (N(0, 0.1)) from ``generator``, in module order.  Fresh weights have
    identity BatchNorms, which a fold leaves unchanged: checks of the
    fold draw these first."""
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            c = m.num_features

            def draw(t):
                return t.to(m.running_mean.device, m.running_mean.dtype)

            m.running_mean.copy_(draw(0.1 * torch.randn(
                c, generator=generator)))
            m.running_var.copy_(draw(0.5 + torch.rand(
                c, generator=generator)))
            m.weight.copy_(draw(0.75 + 0.5 * torch.rand(
                c, generator=generator)))
            m.bias.copy_(draw(0.1 * torch.randn(c, generator=generator)))


def build_folded(cfg, device="cuda", generator=None, **routes):
    """``train.loop.build_model(cfg)`` for serving: built in float32, its
    BatchNorms folded, then cast to the config's dtype (what the JAX tools
    serve: ``fold_batch_norms`` of the float32 variables).  The folded
    float32 weights and biases of its convs stay on the host as
    ``model.float32_state``: int8 weights are quantized from them, as JAX
    quantizes its float32 parameters (``utils/quantize.py``)."""
    from fbbev_tpu_torch.models.builder import detector_kwargs
    from fbbev_tpu_torch.train.loop import build_model
    model_cfg = (cfg.model.to_dict() if hasattr(cfg.model, "to_dict")
                 else dict(cfg.model))
    dtype = routes.pop("dtype", None) or detector_kwargs(model_cfg).get(
        "dtype", torch.float32)
    model = build_model(cfg, device=device, generator=generator,
                        dtype=torch.float32, **routes)
    fold_batch_norms(model)
    model.float32_state = float32_conv_state(model)
    return model.cast(dtype)


def float32_conv_state(model: torch.nn.Module):
    """{``<conv>.weight`` / ``<conv>.bias``: a float32 copy on the host}
    of every ``nn.Conv2d`` / ``nn.Conv3d`` of ``model``."""
    return {f"{n}.{k}": t.detach().to("cpu", torch.float32, copy=True)
            for n, m in model.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))
            for k, t in m.named_parameters(recurse=False)}
