"""Multi-GPU scale-out on ``torch.distributed``.  Counterpart of
``fbbev_tpu/parallel/mesh.py``.

The reference trains with NCCL data parallelism and SyncBN
(``mmdet3d/apis/train.py:229-233``).  The JAX package jits one program
over a ('data', 'space') device mesh; the port runs one process per rank
(``torchrun``) over the same two axes:

* ``data`` -- each data index holds its own batch rows.  BatchNorm
  statistics are taken over the global batch (:func:`sync_batch_norm`,
  what jit over a data-sharded batch computes), the occupancy losses per
  data shard and meaned (JAX ``Trainer._occ_losses_sharded``), and one
  all-reduce of the flat gradient precedes the global-norm clip.
* ``space`` -- the ranks of one data index split the cameras: each runs
  the image encoder and the depth net on ``N / space`` cameras, the LSS
  pool and the BEVFormer camera sum add over ``space``
  (:func:`all_reduce_sum`, JAX's ``psum`` in ``lss.py::_pool``).  The
  BEV stages then split the grid's Y rows over ``space``, JAX's default
  layout (``_bev_spec``: the BEV tensors pinned to ('data', 'space')):
  each rank keeps its rows of the pooled and refined BEV (the pool and
  the backward projection, which needs the whole grid, run replicated),
  and the readd, the history fusion's convs, the 3D encoder, FPN3D and
  the occupancy head compute only its rows (:class:`RowSplit`, the
  nested plan of :func:`split_rows`).  A 3x3x3 conv or an upsample
  fetches the one row its window reaches beyond them from each neighbour
  (:func:`halo`, where GSPMD inserts its halo exchanges); the history
  state stays whole on every rank (JAX's ``state_pspecs``), and the
  occupancy logits and the detection head's input are gathered
  (:meth:`RowSplit.gather`).  BatchNorms behind the split reduce over
  the world (:func:`bn_axis`).

Rank r sits at ``(r // space, r % space)``, the order of JAX's
``np.asarray(devices).reshape(data, space)``.  Model code reads the
active mesh (:func:`use_mesh`, :func:`active_mesh`); without one every
module computes as on one device, with no collective.

The gradient.  Every rank's loss is its *share* of the global objective
(the trainer scales it), so the shares sum over the world to the loss of
the one-process step on the global batch.  Each collective's backward is
the same sum of the gradients that reach it on every rank (a halo's sends
each halo row's gradient back to the row's owner, a gather's sums over
``space`` and returns each rank its own rows), so one sum of the flat
gradient over the world gives every rank that step's gradient.  What the
``space`` ranks of one data index compute as copies (the backward
projection, the gathered losses, the detection head) takes a ``1 /
space`` loss share each; each row behind the split belongs to one rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# batch fields with a camera axis (axis 1), split over 'space'
CAMERA_KEYS = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans",
               "gt_depth")
# how long a collective waits for the other ranks before it raises
INIT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it and the process group of the ranks that differ only there (None:
    size 1 and not the whole world, so nothing to reduce)."""

    size: int
    index: int
    group: Any = None


class Mesh:
    """The ('data', 'space') mesh of an initialised process group, as
    this rank sees it; ``world`` is both axes together."""

    def __init__(self, data: int, space: int, device: torch.device):
        world = dist.get_world_size()
        rank = dist.get_rank()
        assert data * space == world, (data, space, world)
        self.shape = {"data": data, "space": space}
        self.rank, self.device = rank, torch.device(device)
        self.ranks = np.arange(world).reshape(data, space)
        d, s = divmod(rank, space)
        # every rank makes every group, in the same order
        self.data = Axis(data, d, self._groups(
            [self.ranks[:, j].tolist() for j in range(space)], rank))
        self.space = Axis(space, s, self._groups(
            [self.ranks[i, :].tolist() for i in range(data)], rank))
        self.world = Axis(world, rank, dist.group.WORLD)

    @staticmethod
    def _groups(members, rank):
        if len(members[0]) == dist.get_world_size():
            return dist.group.WORLD
        if len(members[0]) == 1:
            return None
        mine = None
        for m in members:
            g = dist.new_group(m)
            if rank in m:
                mine = g
        return mine

    def axis(self, name: str) -> Axis:
        return getattr(self, name)


def make_mesh(data: Optional[int] = None, space: int = 1,
              device=None) -> Mesh:
    """The ('data', 'space') mesh over the initialised process group
    (``data`` defaults to world / space); ``device`` defaults to
    :func:`local_device`."""
    world = dist.get_world_size()
    if data is None:
        data = world // space
    if data * space != world:
        raise ValueError(f"data={data} x space={space} != {world} ranks")
    return Mesh(data, space, device if device is not None
                else local_device())


# ---------------------------------------------------------------------------
# The active mesh: what model code reads.
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Activates ``mesh`` (None: none) for the model code run inside, the
    backward included: enter it around the whole train loop."""
    global _ACTIVE_MESH
    prev, _ACTIVE_MESH = _ACTIVE_MESH, mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


# ---------------------------------------------------------------------------
# Process group and devices.
# ---------------------------------------------------------------------------

def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for
    ``cuda``, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def distributed_init_if_needed(device="cuda", backend: Optional[str] = None,
                               init_method: Optional[str] = None,
                               rank: Optional[int] = None,
                               world_size: Optional[int] = None) -> bool:
    """``init_process_group`` unless one exists: with ``init_method`` (a
    ``file://`` store, say) and ``rank`` / ``world_size``, else from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ...).  The backend is ``nccl`` for ``cuda`` and ``gloo`` for ``cpu``
    unless ``backend`` names one (``gloo`` on the card runs several ranks
    on one device, which NCCL refuses).  Returns whether a group is
    initialised (False: one process, no ``torchrun`` environment).  A
    failing init raises."""
    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if init_method is not None:
        kw = dict(rank=int(rank if rank is not None
                           else os.environ.get("RANK", 0)),
                  world_size=int(world_size if world_size is not None
                                 else os.environ["WORLD_SIZE"]))
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S), **kw)
    return True


# ---------------------------------------------------------------------------
# Collectives (gloo takes card tensors too; every backend wants them
# contiguous).
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sums ``t`` in place over ``axis`` (nothing without a group)."""
    if axis.group is None:
        return t
    c = t.contiguous()
    dist.all_reduce(c, group=axis.group)
    if c is not t:
        t.copy_(c)
    return t


def broadcast_(t: torch.Tensor, axis: Axis, src: int = 0) -> torch.Tensor:
    """``t`` in place from global rank ``src``."""
    if axis.group is None:
        return t
    c = t.contiguous()
    dist.broadcast(c, src, group=axis.group)
    if c is not t:
        t.copy_(c)
    return t


def all_gather(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's ``t`` of ``axis``, stacked on a new axis 0 in rank
    order."""
    if axis.group is None:
        return t[None]
    out = torch.empty(axis.size * t.numel(), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1),
                                group=axis.group)
    return out.view(axis.size, *t.shape)


class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis; its backward sums the gradients of every rank's
    output over the same axis (each rank's input reaches every rank's
    output)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


def all_reduce_sum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``axis_name`` of the active mesh;
    ``x`` itself without a mesh or a group on that axis."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.axis(axis_name).group is None:
        return x
    return _AllReduceSum.apply(x, mesh.axis(axis_name))


# ---------------------------------------------------------------------------
# The BEV row split over 'space'.
# ---------------------------------------------------------------------------

def split_rows(n: int, coarse: int, parts: int) -> List[Tuple[int, int]]:
    """The nested row plan: (start, stop) of each of ``parts`` ranks'
    rows of a level of ``n`` rows (a multiple of ``coarse``, the rows of
    the coarsest level), the coarsest level split as evenly as possible
    (the first ranks one row more) and each finer level taking its factor
    times those rows.  So a stride-2 conv reads one row of the rank
    before, a 3x3x3 stride-1 conv one row of each neighbour and an
    integer-factor upsample at most one input row of each."""
    if n % coarse or not 1 <= parts <= coarse:
        raise ValueError(f"no nested split of {n} rows over {parts} ranks "
                         f"at {coarse} coarse rows")
    q, r = divmod(coarse, parts)
    edge = [i * q + min(i, r) for i in range(parts + 1)]
    f = n // coarse
    return [(f * a, f * b) for a, b in zip(edge[:-1], edge[1:])]


def row_axis() -> Optional[Axis]:
    """The active mesh's ``space`` axis where it splits the BEV rows
    (more than one rank), else None."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.space.group is None:
        return None
    return mesh.space


class _Halo(torch.autograd.Function):
    """x's rows along ``dim`` with ``lo`` rows of the rank before and
    ``hi`` of the rank after on ``axis``; at the grid's own edges zeros
    (a conv's padding) or, with ``clamp``, the edge row repeated (an
    upsample's).  One all-gather of every rank's boundary rows, padded
    to the same size.  The backward sends each halo row's gradient back
    to the rank that owns the row, which adds it in."""

    @staticmethod
    def forward(ctx, x, dim, lo, hi, clamp, axis):
        n = x.shape[dim]
        if n < max(lo, hi):
            raise ValueError(f"{n} rows cannot lend a halo of {lo}/{hi}")
        ctx.args = (dim, lo, hi, clamp, axis)
        s, S = axis.index, axis.size
        # my first hi rows (the rank before's hi halo), my last lo rows
        got = all_gather(torch.cat([x.narrow(dim, 0, hi),
                                    x.narrow(dim, n - lo, lo)], dim), axis)
        if s > 0:
            before = got[s - 1].narrow(dim, hi, lo)
        else:
            before = _edge(x, dim, 0, lo, clamp)
        if s < S - 1:
            after = got[s + 1].narrow(dim, 0, hi)
        else:
            after = _edge(x, dim, n - 1, hi, clamp)
        return torch.cat([before, x, after], dim)

    @staticmethod
    def backward(ctx, g):
        dim, lo, hi, clamp, axis = ctx.args
        s, S = axis.index, axis.size
        n = g.shape[dim] - lo - hi
        g_lo, g_hi = g.narrow(dim, 0, lo), g.narrow(dim, lo + n, hi)
        dx = g.narrow(dim, lo, n).clone()
        got = all_gather(torch.cat([g_lo, g_hi], dim), axis)
        if s < S - 1:
            # the rank after's lo halo is my last lo rows
            dx.narrow(dim, n - lo, lo).add_(got[s + 1].narrow(dim, 0, lo))
        elif clamp:
            dx.narrow(dim, n - 1, 1).add_(g_hi.sum(dim, keepdim=True))
        if s > 0:
            dx.narrow(dim, 0, hi).add_(got[s - 1].narrow(dim, lo, hi))
        elif clamp:
            dx.narrow(dim, 0, 1).add_(g_lo.sum(dim, keepdim=True))
        return dx, None, None, None, None, None


def _edge(x, dim, row, k, clamp):
    """``k`` rows beyond the grid's edge next to ``row``: zeros, or with
    ``clamp`` that row repeated."""
    if clamp:
        e = x.narrow(dim, row, 1)
        return e.expand(*e.shape[:dim], k, *e.shape[dim + 1:])
    shape = list(x.shape)
    shape[dim] = k
    return x.new_zeros(shape)


def halo(x: torch.Tensor, dim: int, lo: int, hi: int, axis: Axis,
         clamp: bool = False) -> torch.Tensor:
    """Differentiable: this rank's rows of x along ``dim`` extended by
    ``lo`` rows of the rank before and ``hi`` of the rank after on
    ``axis`` (:func:`row_axis`), zeros at the grid's own edges or with
    ``clamp`` the edge row repeated."""
    if lo + hi == 0:
        return x
    return _Halo.apply(x, dim, lo, hi, clamp, axis)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows along ``dim`` (``counts`` of them, in rank
    order), concatenated on every rank; the backward sums the gradient
    over the axis and returns each rank its own rows."""

    @staticmethod
    def forward(ctx, x, dim, counts, axis):
        ctx.args = (dim, counts, axis)
        m = max(counts)
        if x.shape[dim] < m:
            x = torch.cat([x, _edge(x, dim, 0, m - x.shape[dim], False)],
                          dim)
        got = all_gather(x, axis)
        return torch.cat([got[i].narrow(dim, 0, c)
                          for i, c in enumerate(counts)], dim)

    @staticmethod
    def backward(ctx, g):
        dim, counts, axis = ctx.args
        g = all_reduce_(g.clone(), axis)
        start = sum(counts[:axis.index])
        return (g.narrow(dim, start, counts[axis.index]).contiguous(), None,
                None, None)


@dataclasses.dataclass
class RowSplit:
    """This rank's BEV rows on ``axis`` (the mesh's ``space``): the
    nested plan (:func:`split_rows`) of a grid whose coarsest level has
    ``coarse`` rows."""

    axis: Axis
    coarse: int

    def __post_init__(self):
        split_rows(self.coarse, self.coarse, self.axis.size)  # or raise

    def ranges(self, n: int) -> List[Tuple[int, int]]:
        """Every rank's (start, stop) of a level of ``n`` rows."""
        return split_rows(n, self.coarse, self.axis.size)

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of a whole grid x along ``dim``."""
        a, b = self.ranges(x.shape[dim])[self.axis.index]
        return x.narrow(dim, a, b - a)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole grid along ``dim`` from every rank's rows x
        (differentiable, :class:`_GatherRows`)."""
        a, b = split_rows(self.coarse, self.coarse,
                          self.axis.size)[self.axis.index]
        f = x.shape[dim] // (b - a)
        if f * (b - a) != x.shape[dim]:
            raise ValueError(f"{x.shape[dim]} rows are not a level of the "
                             f"split of {self.coarse} coarse rows")
        counts = [b - a for a, b in self.ranges(f * self.coarse)]
        return _GatherRows.apply(x, dim, counts, self.axis)


# ---------------------------------------------------------------------------
# Global-batch BatchNorm statistics.
# ---------------------------------------------------------------------------

def bn_axis(mesh: Optional[Mesh], world: bool) -> Optional[Axis]:
    """The axis a training BatchNorm reduces its statistics over: with
    ``world`` the world -- its ranks hold different images (the
    per-camera image stage) or different BEV rows (the stages behind the
    row split) --, else ``data``, the ranks with other samples (the heads
    that run on gathered grids, copies over ``space``); None: local
    statistics."""
    if mesh is None:
        return None
    axis = mesh.world if world else mesh.data
    return axis if axis.group is not None else None


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode affine BatchNorm over axis 1 with the statistics of every
    rank of ``axis``, biased variance, in float32.  Two-pass: the global mean,
    then the global sum of squared deviations from it; the count of values
    is summed with the first pass's sums, since the ranks' BEV rows differ
    in number (float32 counts are exact to 2^24 values).  The backward sums
    ``dy`` and ``dy * x_hat`` over the axis, since the statistics depend
    on every rank's input."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, axis):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        sums = all_reduce_(torch.cat([xf.sum(dims), xf.new_full(
            (1,), x.numel() // x.shape[1])]), axis)
        n = sums[-1]  # the values of every rank
        mean = sums[:-1] / n
        xc = xf - mean.view(shape)
        var = all_reduce_((xc * xc).sum(dims), axis) / n
        invstd = torch.rsqrt(var + eps)
        y = (xc * (invstd * weight.float()).view(shape)
             + bias.float().view(shape))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.axis, ctx.n = axis, n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        dyf = dy.float()
        # this rank's own sums are its weight and bias gradients
        sums = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        db, dw = sums.chunk(2)
        mdy, mdyx = (all_reduce_(sums.clone(), ctx.axis) / ctx.n).chunk(2)
        dx = (dyf - mdy.view(shape) - xhat * mdyx.view(shape)) * (
            invstd * weight.float()).view(shape)
        return (dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype),
                None, None)


def sync_batch_norm(x: torch.Tensor, weight, bias, eps: float, axis: Axis
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, batch mean, biased batch variance) of a train-mode affine
    BatchNorm over axis 1 of ``x`` with the statistics of every rank of
    ``axis``; the statistics carry no gradient."""
    return _SyncBatchNorm.apply(x, weight, bias, eps, axis)


# ---------------------------------------------------------------------------
# Batches and state.
# ---------------------------------------------------------------------------

def split_cameras(batch: Dict[str, Any], mesh: Optional[Mesh]
                  ) -> Dict[str, Any]:
    """This rank's cameras (axis 1 of :data:`CAMERA_KEYS`) of a batch:
    ``N / space`` of them, from ``space index * N / space``.  ``space``
    must divide N."""
    if mesh is None or mesh.space.size == 1:
        return batch
    S, s = mesh.space.size, mesh.space.index
    out = dict(batch)
    for k in CAMERA_KEYS:
        if k in batch:
            N = batch[k].shape[1]
            if N % S:
                raise ValueError(f"space={S} does not divide the {N} "
                                 f"cameras of {k!r}")
            out[k] = batch[k][:, s * N // S:(s + 1) * N // S]
    return out


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]
                ) -> Dict[str, Any]:
    """This rank's slice of a GLOBAL batch: its ``B / data`` rows, and
    with ``space > 1`` its cameras (:func:`split_cameras`).  The train and
    eval loops read each data index's own rows from the sampler and split
    only the cameras."""
    if mesh is None:
        return batch
    D, d = mesh.data.size, mesh.data.index
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % D:
            raise ValueError(f"data={D} does not divide the batch of {B} "
                             f"({k!r})")
        out[k] = v[d * B // D:(d + 1) * B // D]
    return split_cameras(out, mesh)


def _map_state(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_state(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_state(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_state(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_state(fn, v) for k, v in tree.items()}
    return tree


def replicate(tree, mesh: Optional[Mesh]):
    """Every tensor of ``tree`` (a TrainState, a dict, ...) as rank 0
    holds it, on every rank; python scalars are left as they are (every
    rank computes them alike)."""
    if mesh is None:
        return tree
    return _map_state(lambda t: broadcast_(t.clone(), mesh.world), tree)


def gather_to_host(tree, mesh: Optional[Mesh], axis: str = "data"):
    """Every tensor of ``tree`` gathered over ``axis`` and concatenated
    on its axis 0 in rank order, as numpy on every rank (the reference's
    tmpdir-pickle gather, ``apis/test.py:210-256``)."""
    def gather(t):
        if mesh is None:
            return t.detach().cpu().numpy()
        g = all_gather(t.detach(), mesh.axis(axis))
        if t.dim():
            g = g.reshape(-1, *t.shape[1:])
        return g.cpu().numpy()
    return _map_state(gather, tree)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier()

