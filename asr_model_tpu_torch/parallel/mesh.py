"""The process mesh over ``torch.distributed`` ranks, and the collectives
the parallel paths use.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``;
here each rank is a process.  ``make_mesh(data, model, seq, expert)``
lays the ranks out row-major over the axes ("data", "model", "seq",
"expert") (``make_pipe_mesh`` over ("data", "pipe")), as the JAX mesh
lays out its devices, and creates, on every rank and in one order, the
process group of every set of axes: ``mesh.axis("model")`` is this
rank's group along "model" with its size and this rank's index in it,
``mesh.axis("data", "seq")`` the group of the ranks that differ only in
those axes.  Without an initialised process group the world is this one
process and every group is the rank alone.

The collectives are differentiable as the JAX package's SPMD gradients
are: every rank's loss is its part of one sum over the ranks
(``parallel/sharding.py`` scales it so), so the backward of a sum over a
group is the sum of the cotangents over the group (``psum``), and an
all-gather's backward sums the cotangents and takes this rank's block
(``gather``).  They are built on ``all_reduce`` alone, which gloo also
takes on CUDA tensors.

``initialize_distributed`` joins (or starts) the group: NCCL for CUDA
devices, gloo for the CPU; a rank's device is ``cuda:<local rank>``
unless the caller names one.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

MeshAxes = ("data", "model", "seq", "expert")
PipeAxes = ("data", "pipe")


def world() -> tuple:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Axis:
    """One rank's view of a group of mesh axes: the process group (None
    when it is this rank alone), its size and this rank's index in it."""

    def __init__(self, names: tuple, group, size: int, index: int):
        self.names, self.group = names, group
        self.size, self.index = size, index

    def __repr__(self):
        return f"Axis({'x'.join(self.names) or '-'}, {self.index}/{self.size})"


class Mesh:
    def __init__(self, shape: Dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = math.prod(shape.values())
        rank, n = world()
        if n < self.size:
            dims = "x".join(str(v) for v in shape.values())
            raise ValueError(f"mesh {dims} needs {self.size} devices, "
                             f"have {n}")
        if n > self.size:
            raise ValueError(f"mesh of {self.size} ranks in a group of {n}: "
                             "start as many ranks as the mesh holds")
        self.rank = rank
        sizes = [shape[a] for a in self.axis_names]
        coords, r = [], rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(self.axis_names, reversed(coords)))
        self._build_groups()

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _build_groups(self) -> None:
        """Every rank creates every group in the same order (``new_group``
        is collective); a set of axes whose other axes are all of size 1
        shares the group of its nontrivial axes."""
        live = [a for a in self.axis_names if self.shape[a] > 1]
        made: Dict[frozenset, Axis] = {frozenset(): Axis((), None, 1, 0)}
        for k in range(1, len(live) + 1):
            for sub in itertools.combinations(live, k):
                made[frozenset(sub)] = self.new_axis(*sub)
        self._made = made

    def new_axis(self, *sub: str) -> Axis:
        """A new set of groups along the axes ``sub`` (every rank calls
        it), and this rank's: the pipeline's stage hops take their own, so
        no point-to-point message shares a group with a collective."""
        rest = [a for a in self.axis_names if a not in sub]
        mine = None
        for fixed in itertools.product(*[range(self.shape[a]) for a in rest]):
            base = dict(zip(rest, fixed))
            ranks = [self._rank_of(base | dict(zip(sub, moving)))
                     for moving in itertools.product(
                         *[range(self.shape[a]) for a in sub])]
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = Axis(sub, group, len(ranks), ranks.index(self.rank))
        return mine

    def axis(self, *names: str) -> Axis:
        """This rank's group along ``names`` (order-free)."""
        for a in names:
            if a not in self.shape:
                raise KeyError(f"mesh has no axis {a!r}")
        live = frozenset(a for a in names if self.shape[a] > 1)
        return self._made[live]

    def others(self, *names: str) -> Axis:
        """The group along every axis but ``names``."""
        return self.axis(*[a for a in self.axis_names if a not in names])

    def __repr__(self):
        return ("Mesh(" + ", ".join(f"{a}={self.shape[a]}"
                                    for a in self.axis_names)
                + f"; rank {self.rank})")


def make_mesh(data: int = 1, model: int = 1, seq: int = 1,
              expert: int = 1) -> Mesh:
    """A (data, model, seq, expert) mesh over the group's ranks; a
    ValueError where the group has fewer ranks than the mesh needs."""
    return Mesh(dict(zip(MeshAxes, (data, model, seq, expert))))


def make_pipe_mesh(pipe: int, data: int = 1) -> Mesh:
    """A (data, pipe) mesh: the stages of one pipeline are adjacent
    ranks; ``mesh.hops`` is a second set of 'pipe' groups for the stage
    hops (gloo would match a send against a collective's message on a
    shared group)."""
    n = data * pipe
    if world()[1] < n:
        raise ValueError(f"pipe mesh {data}x{pipe} needs {n} devices, "
                         f"have {world()[1]}")
    mesh = Mesh(dict(zip(PipeAxes, (data, pipe))))
    mesh.hops = mesh.new_axis("pipe") if pipe > 1 else mesh.axis("pipe")
    return mesh


def initialize_distributed(rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           init_method: Optional[str] = None,
                           device=None, backend: Optional[str] = None
                           ) -> torch.device:
    """Join the process group and return this rank's device.  Without
    arguments the ``torchrun`` environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT) is read; a world of one process
    initialises a group only when ``init_method`` is given.  ``device`` None is ``cuda:<local rank>``;
    ``backend`` None is NCCL on a CUDA device, gloo on the CPU."""
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(env.get("RANK", "0"))
    local = int(env.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} needs cuda:{local}; this machine has "
                f"{torch.cuda.device_count()} CUDA device(s)")
        device = f"cuda:{local}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized() and (world_size > 1 or init_method):
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    return dev


# ---------------------------------------------------------------------------
# collectives


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of ``x`` over the group (identity for a group of one);
    differentiable (module doc)."""
    if axis is None or axis.group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _PSum.apply(x, axis.group)
    y = x.contiguous().clone()
    dist.all_reduce(y, group=axis.group)
    return y


def pmax(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The elementwise max over the group, no gradient."""
    if axis is None or axis.group is None:
        return x.detach()
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=axis.group)
    return y


def gather(x: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    """Concatenate the group's blocks of ``x`` along ``dim`` in group
    order (every block the same shape): a sum of zero-padded blocks, so
    the backward sums the cotangents and keeps this rank's block."""
    if axis is None or axis.group is None:
        return x
    dim = dim % x.dim()
    n, i = axis.size, axis.index
    shape = list(x.shape)
    pad = []
    if i:
        pad.append(x.new_zeros(shape[:dim] + [shape[dim] * i]
                               + shape[dim + 1:]))
    pad.append(x)
    if n - 1 - i:
        pad.append(x.new_zeros(shape[:dim] + [shape[dim] * (n - 1 - i)]
                               + shape[dim + 1:]))
    return psum(torch.cat(pad, dim=dim), axis)


def block(x: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``gather``'s inverse)."""
    if axis is None or axis.size == 1:
        return x
    return x.chunk(axis.size, dim=dim)[axis.index]


def broadcast_from(x: torch.Tensor, axis: Optional[Axis], src: int):
    """``x`` of the group's rank ``src`` (group index) on every rank: a
    sum where every other rank adds zeros (differentiable)."""
    if axis is None or axis.group is None:
        return x
    return psum(x if axis.index == src else torch.zeros_like(x), axis)
