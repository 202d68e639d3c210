"""The collectives a mesh step runs inside the net, and the scope that
hands them their groups.

The train step is functional (train/trainer.py): the net runs through
``torch.func.functional_call`` on a dict of tensors, so the process
groups reach the layers that need them through a scope the step enters,
not through module attributes. Outside a scope every function here is
the single-device code: :func:`data_group` and :func:`model_group` return
None, and :func:`draw_rows` draws at the shape it is given.

* Global BatchNorm (nn/norm.py) all-reduces its sums over the ``"data"``
  group with :func:`all_reduce` (autograd carries through it, so input
  gradients are those of one BatchNorm over the global batch).
* A row-sharded margin head (nn/loss.py) takes its input through
  :func:`copy_to_model` (identity forward, gradient summed over
  ``"model"``) and gathers its cosines with :func:`gather_from_model`
  (all-gather forward, the rank's own columns backward): the head's
  values are the unsharded head's, and each model rank's loss is the same
  replicated value.
* Losses coupled across the batch (the FD regulariser's mean cosine, the
  sub-centre head's batch-mean threshold and rectangle normaliser,
  CurricularFace's mean, the pairwise affinity loss, a summed focal loss,
  a masked frame mean) take global values through :func:`batch_mean`,
  :func:`batch_sum`, :func:`batch_logsumexp` and
  :func:`all_gather_with_grad`: each rank's loss is then the global
  batch's, and the mean of the ranks' gradients is its gradient.
* Per-row random draws (SpecAugment, dropout, mixup's permutation) go
  through :func:`draw_rows`: every rank draws at the global batch's shape
  from the same generator and keeps its rows, so a step's value does not
  depend on the placement.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh dim as the step sees it: its process group, size and this
    process's index along it."""

    group: object
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class Scope:
    data: Optional[Axis] = None
    model: Optional[Axis] = None
    # the current microbatch: rows [start, start + local) of global_rows
    global_rows: int = 0
    start: int = 0
    local: int = 0


_SCOPE: Optional[Scope] = None


@contextlib.contextmanager
def scope(data: Optional[Axis], model: Optional[Axis], global_rows: int = 0, start: int = 0,
          local: int = 0) -> Iterator[Scope]:
    """Run the body with these groups and this row window."""
    global _SCOPE
    saved = _SCOPE
    _SCOPE = Scope(data, model, global_rows, start, local)
    try:
        yield _SCOPE
    finally:
        _SCOPE = saved


def current() -> Optional[Scope]:
    return _SCOPE


def data_group() -> Optional[Axis]:
    return _SCOPE.data if _SCOPE is not None else None


def model_group() -> Optional[Axis]:
    return _SCOPE.model if _SCOPE is not None else None


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)``, or under a scope whose microbatch has ``shape[0]``
    rows, this rank's rows of ``draw`` at the global batch's shape."""
    s = _SCOPE
    shape = tuple(shape)
    if s is None or s.global_rows == s.local or not shape or shape[0] != s.local:
        return draw(shape)
    return draw((s.global_rows, *shape[1:]))[s.start:s.start + s.local]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, with autograd (the gradient is
    summed over the axis too)."""
    return _AllReduce.apply(x, axis.group)


def all_gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` of every rank of ``axis`` concatenated along dim 0, without
    gradient (the step's data: features, labels)."""
    if axis.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, 0)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width], None, None, None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity forward; the gradient is summed over the ``"model"`` group
    (each model rank's columns contribute a part of it)."""
    return _CopyToModel.apply(x, axis.group)


def gather_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ``"model"`` group's column blocks of ``x`` concatenated along
    the last dim. The backward keeps this rank's block of the gradient,
    which is right where every model rank computes the same value from
    the result (the margin head's loss over replicated rows)."""
    return _GatherFromModel.apply(x, axis.group, axis.size, axis.rank)


def batch_mean(value: torch.Tensor) -> torch.Tensor:
    """A mean over this rank's rows -> the mean over the global batch (the
    ranks hold equal shares), with autograd; ``value`` outside a scope."""
    axis = data_group()
    return value if axis is None else all_reduce(value, axis) / axis.size


def batch_rows(local: int) -> int:
    """The global batch's rows from this rank's ``local``."""
    axis = data_group()
    return local if axis is None else local * axis.size


def batch_sum(value: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's rows -> the sum over the global batch."""
    axis = data_group()
    return value if axis is None else all_reduce(value, axis)


def batch_logsumexp(value: torch.Tensor) -> torch.Tensor:
    """A logsumexp over this rank's rows (0-dim) -> the global batch's."""
    axis = data_group()
    if axis is None:
        return value
    mine = torch.arange(axis.size, device=value.device) == axis.rank
    return torch.logsumexp(all_reduce(torch.where(mine, value, torch.zeros_like(value)), axis), 0)


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``x`` in rank order, with autograd (the
    gradient of each block is summed over the ranks); ``x`` outside a
    scope."""
    axis = data_group()
    return x if axis is None else _AllGatherRows.apply(x, axis.group, axis.size)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        blocks = [b.contiguous() for b in g.chunk(ctx.size)]
        mine = torch.empty_like(blocks[0])
        dist.reduce_scatter(mine, blocks, group=ctx.group)
        return mine, None, None
