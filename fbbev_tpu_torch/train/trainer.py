"""Training runtime: the train step with an explicit temporal-state carry,
AdamW + warmup + gradient clipping, MEGVII EMA.  Counterpart of
``fbbev_tpu/train/trainer.py``.

The step is functional in its state, as the JAX one:

    (TrainState, TemporalState, batch) -> (TrainState', TemporalState', metrics)

A :class:`TrainState` holds float32 master parameters, BatchNorm running
statistics, the Adam moments and the EMA as flat tensors (one element per
scalar, in the order of the model's ``named_parameters`` /
BatchNorm buffers; :meth:`Trainer.unflatten` gives them back by name).
The model itself computes in its own dtype (bf16 at the flagship, with
the float32 islands of the JAX modules; every BatchNorm is float32): each
step first copies the state into it.  Losses are float32.

The optimizer is optax's ``chain(clip_by_global_norm(5), adamw(lr 2e-4,
wd 1e-2, eps 1e-8))`` with a linear warmup, re-implemented with its exact
formulas (``clip_grad_norm_`` differs: it adds 1e-6 to the norm and
always scales); ``frozen`` zeroes the updates of whole top-level modules,
keeps them out of the clipping norm and keeps their BatchNorm statistics,
as ``optax.multi_transform`` with ``set_to_zero`` does there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from fbbev_tpu_torch.models import losses as loss_lib
from fbbev_tpu_torch.models.depth_net import depth_loss
from fbbev_tpu_torch.models.fbocc import DEFAULT_GRID_CONFIG, TemporalState
from fbbev_tpu_torch.models.occ_head import occ_losses
from fbbev_tpu_torch.train.ema import ema_update, megvii_ema_decay


def lr_schedule(base_lr: float = 2e-4, warmup_iters: int = 200,
                warmup_ratio: float = 1e-3) -> Callable[[int], float]:
    """Linear warmup from ``base_lr * warmup_ratio`` over ``warmup_iters``
    updates, then constant; the learning rate of update ``count`` (0 for
    the first), as ``optax.join_schedules`` of the two gives it."""
    init = base_lr * warmup_ratio

    def lr(count: int) -> float:
        if count >= warmup_iters:
            return base_lr
        return (init - base_lr) * (1.0 - count / warmup_iters) + base_lr

    return lr


@dataclasses.dataclass
class AdamState:
    count: int            # updates applied so far
    mu: torch.Tensor      # first moment, flat f32
    nu: torch.Tensor      # second moment, flat f32


# optax.adamw's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class Optimizer:
    """Global-norm clipping then AdamW on flat float32 tensors."""

    lr: Callable[[int], float]
    weight_decay: float = 1e-2
    max_grad_norm: float = 5.0
    frozen: Tuple[str, ...] = ()

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(params),
                         torch.zeros_like(params))

    def update(self, grads: torch.Tensor, state: AdamState,
               params: torch.Tensor, trainable: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, AdamState]:
        """Returns (updates, new state); ``trainable`` is a flat 0/1 mask
        (None: all), the frozen entries get no update."""
        # in-place on fresh tensors, in optax's order of operations: a
        # flat vector is a model's worth of parameters
        g = grads.clone() if trainable is None else grads * trainable
        # optax.global_norm's square root of a sum of squares:
        # torch.linalg.vector_norm accumulates a long float32 vector in
        # order on the CPU and comes out 0.3% low at 30M elements
        g_norm = torch.sqrt(torch.sum(g * g))
        # g / g_norm * max_norm where clipped, else g / 1 * 1 (exact):
        # no branch on a device value, so the step does not wait for it
        clip = g_norm >= self.max_grad_norm
        g.div_(torch.where(clip, g_norm, 1.0)).mul_(
            torch.where(clip, self.max_grad_norm, 1.0))
        count = state.count + 1
        mu = torch.mul(g, 1.0 - B1).add_(state.mu, alpha=B1)
        nu = g.mul_(g).mul_(1.0 - B2).add_(state.nu, alpha=B2)
        u = torch.div(mu, 1.0 - B1 ** count)
        u.div_(torch.div(nu, 1.0 - B2 ** count).sqrt_().add_(EPS))
        u.add_(params, alpha=self.weight_decay).mul_(-self.lr(state.count))
        if trainable is not None:
            u.mul_(trainable)
        return u, AdamState(count, mu, nu)


def make_optimizer(base_lr: float = 2e-4, weight_decay: float = 1e-2,
                   max_grad_norm: float = 5.0, warmup_iters: int = 200,
                   warmup_ratio: float = 1e-3,
                   frozen: Tuple[str, ...] = ()) -> Optimizer:
    """AdamW + global-norm clip, optionally with frozen top-level modules
    (their updates zeroed), as ``trainer.py:61`` of the JAX package."""
    return Optimizer(lr_schedule(base_lr, warmup_iters, warmup_ratio),
                     weight_decay, max_grad_norm, frozen=tuple(frozen))


@dataclasses.dataclass
class TrainState:
    step: int
    params: torch.Tensor           # flat f32 master parameters
    batch_stats: torch.Tensor      # flat f32 BatchNorm running statistics
    opt_state: AdamState
    ema_params: torch.Tensor
    ema_batch_stats: torch.Tensor
    ema_updates: float


def _stats_buffers(model: torch.nn.Module) -> List[Tuple[str, torch.Tensor]]:
    return [(n, b) for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


class Trainer:
    """The train and eval steps of an FBOCC-style model (``model.forward(
    batch, state, train, do_history)``), counterpart of the JAX
    ``Trainer``.  Turns the model's BatchNorms to float32."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: Optional[Optimizer] = None,
                 ema_base_decay: float = 0.999, ema_init_updates: int = 0,
                 depth_loss_weight: float = 1.0, num_classes: int = 19,
                 use_depth_supervision: Optional[bool] = None,
                 frozen: Tuple[str, ...] = (), lovasz: str = "hist"):
        self.model = model
        self.optimizer = optimizer or make_optimizer()
        self.ema_base_decay = ema_base_decay
        self.ema_init_updates = ema_init_updates
        self.depth_loss_weight = depth_loss_weight
        # None: the model's own switch (an FBOCC's ``use_depth_supervision``)
        self.use_depth_supervision = (
            getattr(model, "use_depth_supervision", True)
            if use_depth_supervision is None else use_depth_supervision)
        # top-level modules whose BatchNorm statistics stay put (pair with
        # make_optimizer(frozen=...))
        self.frozen = tuple(frozen)
        self.lovasz = lovasz
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.float()
        self.params = list(model.named_parameters())
        self.buffers = _stats_buffers(model)
        dev = self.params[0][1].device
        self._class_weights = torch.from_numpy(
            loss_lib.occ_class_weights(num_classes)).to(dev)
        self._trainable = self._mask(self.params, self.optimizer.frozen)
        self._frozen_stats = self._mask(self.buffers, self.frozen)

    # ------------------------------------------------------------------
    def _mask(self, named: Sequence[Tuple[str, torch.Tensor]],
              frozen: Tuple[str, ...]) -> Optional[torch.Tensor]:
        """Flat 1/0 mask of the tensors outside / inside ``frozen``."""
        if not frozen:
            return None
        return torch.cat([torch.full((t.numel(),),
                                     0.0 if n.split(".")[0] in frozen
                                     else 1.0, device=t.device)
                          for n, t in named])

    @staticmethod
    def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t.detach().float().reshape(-1) for t in tensors])

    def unflatten(self, flat: torch.Tensor, what: str = "params"
                  ) -> Dict[str, torch.Tensor]:
        """{name: tensor} views of a flat state tensor; ``what`` is
        "params" or "batch_stats"."""
        named = self.params if what == "params" else self.buffers
        out, i = {}, 0
        for n, t in named:
            out[n] = flat[i:i + t.numel()].view(t.shape)
            i += t.numel()
        return out

    @torch.no_grad()
    def _load(self, params: torch.Tensor, batch_stats: torch.Tensor):
        """Copy flat f32 state into the model (in its dtypes)."""
        for (_, p), v in zip(self.params, self.unflatten(params).values()):
            p.copy_(v)
        for (_, b), v in zip(self.buffers,
                             self.unflatten(batch_stats,
                                            "batch_stats").values()):
            b.copy_(v)

    def init_state(self) -> TrainState:
        """The state of the model's current weights, Adam at zero."""
        params = self._flat([p for _, p in self.params])
        stats = self._flat([b for _, b in self.buffers])
        return TrainState(step=0, params=params, batch_stats=stats,
                          opt_state=self.optimizer.init(params),
                          ema_params=params.clone(),
                          ema_batch_stats=stats.clone(),
                          ema_updates=float(self.ema_init_updates))

    # ------------------------------------------------------------------
    def losses(self, outputs: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The occupancy losses and the depth loss, float32."""
        out = {}
        if "occ_logits" in outputs and "gt_occupancy" in batch:
            logits = outputs["occ_logits"]
            H, W = logits.shape[1], logits.shape[2]
            dist_w = torch.from_numpy(loss_lib.bev_distance_weight(H, W)).to(
                logits.device)
            out = occ_losses(logits, batch["gt_occupancy"],
                             self._class_weights, dist_w, lovasz=self.lovasz)
        if self.use_depth_supervision and "gt_depth" in batch:
            gc = getattr(self.model, "grid_config", DEFAULT_GRID_CONFIG)
            out["loss_depth"] = depth_loss(
                batch["gt_depth"], outputs["depth"], self.model.downsample,
                gc["depth"], self.depth_loss_weight)
        return out

    def train_step(self, state: TrainState, temporal_state: TemporalState,
                   batch: Dict[str, torch.Tensor], do_history: bool = True):
        """One optimizer step.  Returns (new TrainState, new TemporalState,
        metrics: each ``loss_*``, ``loss_total``, ``grad_norm`` and
        ``seq_mismatch``, as 0-d tensors).  ``state`` is left as it was."""
        model = self.model
        self._load(state.params, state.batch_stats)
        model.zero_grad(set_to_none=True)
        outputs, new_tstate = model(batch, temporal_state, train=True,
                                    do_history=do_history)
        losses = self.losses(outputs, batch)
        total = sum(losses.values())
        total.backward()
        grads = self._flat([torch.zeros_like(p) if p.grad is None else p.grad
                            for _, p in self.params])
        new_bs = self._flat([b for _, b in self.buffers])
        if self._frozen_stats is not None:
            new_bs = torch.where(self._frozen_stats > 0, new_bs,
                                 state.batch_stats)
        updates, opt_state = self.optimizer.update(
            grads, state.opt_state, state.params, self._trainable)
        new_params = state.params + updates
        ema_updates = state.ema_updates + 1.0
        decay = megvii_ema_decay(ema_updates, self.ema_base_decay)
        new_state = TrainState(
            step=state.step + 1, params=new_params, batch_stats=new_bs,
            opt_state=opt_state,
            ema_params=ema_update(state.ema_params, new_params, decay),
            ema_batch_stats=ema_update(state.ema_batch_stats, new_bs, decay),
            ema_updates=ema_updates)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_total"] = total.detach()
        metrics["grad_norm"] = torch.sqrt(torch.sum(grads * grads))
        metrics["seq_mismatch"] = outputs["seq_mismatch"].sum()
        model.zero_grad(set_to_none=True)
        return new_state, new_tstate, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, temporal_state: TemporalState,
                  batch: Dict[str, torch.Tensor], use_ema: bool = True):
        """The eval forward with the EMA (or the live) weights: (outputs,
        new TemporalState)."""
        self._load(state.ema_params if use_ema else state.params,
                   state.ema_batch_stats if use_ema else state.batch_stats)
        return self.model(batch, temporal_state, train=False,
                          do_history=True)
