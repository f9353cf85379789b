"""What a module needs to know of the mesh while a sharded forward runs.

``batch_pmean(axis)`` (the JAX package's ``sheath.batch_pmean``): while
it is open, the batch rows of the forward are this rank's block of a
batch sharded over ``axis``, and every batch-coupled statistic is taken
over the whole batch, as the JAX package's SPMD program takes it:
MSheath's jump-control scalars, BatchNorm's train statistics, the MoE
aux means (``batch_sum``, ``batch_count``).  The train generator's draws
of a batch-shaped tensor are drawn at the whole batch's shape and cut to
this rank's rows (``draw``), which is how a sharded ``jax.random`` draw
partitions; a draw that is not batch-shaped (MSheath's policy noise,
inside ``whole_draws``) is the same on every rank.
``draw_blocks(dim, axis)`` does the same for a dimension sharded by
tensor parallelism (the attention's heads under its head norm).

The state is a plain module global, not per thread: the recompute of a
checkpointed piece runs on autograd's thread inside the backward, and
must see the forward's sharding.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from asr_model_tpu_torch.parallel.mesh import Axis, psum

_BATCH: list = []
_BLOCKS: list = []
_WHOLE = [0]


@contextlib.contextmanager
def batch_pmean(axis: Optional[Axis]):
    """Batch rows sharded over ``axis`` (None or a group of one: not
    sharded) for the duration."""
    on = axis is not None and axis.size > 1
    if on:
        _BATCH.append(axis)
    try:
        yield
    finally:
        if on:
            _BATCH.pop()


def batch_axis() -> Optional[Axis]:
    return _BATCH[-1] if _BATCH else None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the batch's shards (identity when unsharded)."""
    return psum(t, batch_axis())


def batch_count(n: int) -> int:
    """The whole batch's count of what this rank counts ``n`` of, with
    equal shards."""
    ax = batch_axis()
    return n * (ax.size if ax is not None else 1)


def global_mean(t: torch.Tensor, dims) -> torch.Tensor:
    """The mean over ``dims`` (dim 0 the batch rows among them) of the
    whole sharded batch."""
    n = 1
    for d in dims:
        n *= t.shape[d]
    return batch_sum(t.sum(dim=dims)) / batch_count(n)


def global_masked_mean(t: torch.Tensor, valid) -> torch.Tensor:
    """The mean of ``t`` (B, T, 1) over the valid positions of the whole
    batch: sums and counts combined across the shards (a mean of the
    shards' means would weigh them wrong)."""
    m = valid.to(t.dtype)[..., None]
    s = batch_sum(torch.sum(t * m))
    n = batch_sum(torch.sum(m))
    return s / torch.clamp(n, min=1.0)


@contextlib.contextmanager
def draw_blocks(dim: int, axis: Optional[Axis]):
    """Draws of the train generator take dimension ``dim`` as this rank's
    block of ``axis`` (tensor-parallel heads) for the duration."""
    on = axis is not None and axis.size > 1
    if on:
        _BLOCKS.append((dim, axis))
    try:
        yield
    finally:
        if on:
            _BLOCKS.pop()


@contextlib.contextmanager
def whole_draws():
    """Draws made for the whole batch at once (not batch-shaped) for the
    duration: no rank cuts them."""
    _WHOLE[0] += 1
    try:
        yield
    finally:
        _WHOLE[0] -= 1


def draw(shape, fn) -> torch.Tensor:
    """``fn(shape)`` as the unsharded forward draws it, cut to this
    rank's block: dim 0 by the batch axis (outside ``whole_draws``), and
    each ``draw_blocks`` dimension by its axis."""
    cuts = []
    if _BATCH and not _WHOLE[0]:
        cuts.append((0, _BATCH[-1]))
    cuts.extend(_BLOCKS)
    if not cuts:
        return fn(tuple(shape))
    full = list(shape)
    for dim, ax in cuts:
        full[dim] *= ax.size
    t = fn(tuple(full))
    for dim, ax in cuts:
        t = t.narrow(dim, ax.index * shape[dim], shape[dim])
    return t
