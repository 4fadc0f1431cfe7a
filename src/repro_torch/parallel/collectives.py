"""Collectives over a mesh of ranks: what executes the reference's sharding
plan with `torch.distributed`.

`Comm(mesh)` lays the process group out as a `launch.mesh.Mesh`: ranks are
numbered row-major over the mesh's axes, the last axis innermost (as
`analysis.trace._off_node` numbers a plan's devices), and every subset of
the axes whose size is above 1 gets its sub-groups, made once by every rank
in the same order. A group's ranks in ascending order are its members in
row-major order over its axes, so shard `i` of a dimension that a spec
splits over those axes (the first axis major, as `PartitionSpec` reads) is
the block of the `i`-th member.

The raw collectives (`all_gather`, `reduce_scatter`, `all_reduce`,
`all_to_all`) take the dimension they gather, scatter or split along and
count each call in `Comm.stats`: its kind, group size and bytes through a
device's links by the dry run's ring model (`analysis.trace.
collective_transfer`), so an executed step and its dry run are read in one
unit. The autograd Functions pair each with the backward Megatron and ZeRO
give it: an all-gather whose backward reduce-scatters, a reduce-scatter
whose backward all-gathers, an all-reduce whose backward is the identity
(a sum every rank goes on from), an identity whose backward all-reduces,
and an all-to-all whose backward is the inverse all-to-all.
`gathered_mm` is ZeRO-3's product with a sharded weight: the weight is
all-gathered over its FSDP axes for the product and again for the
backward where the input takes a gradient (a projection of the data,
`frame_proj` or `img_proj`, does not), which reduce-scatters the weight's
gradient; it is one dispatcher op (`torch.ops.repro_torch.gathered_mm`),
so a selective remat that keeps products (`models.model.save_dots`) keeps
its output and does not gather again.

`gather` brings every rank's tensor to one rank (a checkpoint's leaves
to the rank that writes them). `close` forgets a Comm's sub-groups; a
Comm that is dropped is forgotten by `gathered_mm`'s registry as well.

The backend is the caller's: `nccl` with one rank a card, `gloo` on the
CPU. Under `gloo` a CUDA tensor goes through host memory: each collective
copies its input to the host, runs there and copies the result back. That
is only for ranks that share one card (chip_smoke.py's phase 10); its times
are no measure of the plan. NCCL with more ranks on a host than it has
cards raises; nothing switches backends on a failure.
"""
from __future__ import annotations

import itertools
import math
import os
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.trace import collective_transfer

# `*_single` in newer torch; the same call under its older name before
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def rank_coords(mesh, rank: int) -> Dict[str, int]:
    """A rank's coordinate on each mesh axis: row-major, the last axis
    innermost."""
    out = {}
    for name in reversed(mesh.axis_names):
        size = mesh.shape[name]
        out[name] = rank % size
        rank //= size
    return {a: out[a] for a in mesh.axis_names}


def axes_index(mesh, coords: Dict[str, int], axes: Sequence[str]) -> int:
    """The index of `coords` over `axes`, the first axis major."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


@dataclass
class CollectiveStats:
    """The ring-model bytes through a device's links of every collective a
    `Comm` ran, by kind."""
    by_kind: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    def add(self, op: str, n: int, in_b: int, out_b: int) -> None:
        self.by_kind[op] += collective_transfer(op, n, in_b, out_b)

    def reset(self) -> None:
        self.by_kind.clear()

    def snapshot(self) -> Dict[str, float]:
        return dict(self.by_kind)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# `gathered_mm` takes its group by number: a custom op's arguments are
# tensors and scalars. Each live Comm's numbers, held weakly: a Comm that
# is closed or dropped takes its numbers out.
_GROUPS: Dict[int, Tuple["weakref.ref[Comm]", Tuple[str, ...]]] = {}
_NUMBERS = itertools.count()


def _forget(keys: list) -> None:
    for k in keys:
        _GROUPS.pop(k, None)


def _comm_of(key: int) -> Tuple["Comm", Tuple[str, ...]]:
    ref, axes = _GROUPS[key]
    comm = ref()
    if comm is None:
        raise RuntimeError(f"group number {key}: its Comm is gone")
    return comm, axes


class Comm:
    """The process group as `mesh`: this rank's coordinates, the sub-group
    of every axis subset, the collectives and their counts."""

    def __init__(self, mesh):
        if not dist.is_initialized():
            raise RuntimeError("no process group: torch.distributed."
                               "init_process_group comes first")
        world = dist.get_world_size()
        if mesh.size != world:
            raise ValueError(f"mesh {mesh.shape} has {mesh.size} devices; "
                             f"the process group has {world} ranks")
        self._setup(mesh, dist.get_rank(), dist.get_backend())
        local = int(os.environ.get("LOCAL_WORLD_SIZE", self.world))
        if self.backend == "nccl" and local > torch.cuda.device_count():
            raise RuntimeError(f"nccl with {local} ranks on a host of "
                               f"{torch.cuda.device_count()} cards: one rank "
                               "a card (gloo shares a card, through host "
                               "memory)")
        names = mesh.axis_names
        all_ranks = list(range(self.world))
        for axes in self._groups:
            others = [a for a in names if a not in axes]
            mine = None
            for fixed in itertools.product(
                    *(range(mesh.shape[a]) for a in others)):
                ranks = sorted(
                    r for r in all_ranks
                    if all(rank_coords(mesh, r)[a] == c
                           for a, c in zip(others, fixed)))
                group = dist.group.WORLD if ranks == all_ranks \
                    else dist.new_group(ranks)
                if self.rank in ranks:
                    mine = group
            self._groups[axes] = (mine, self._groups[axes][1])

    def _setup(self, mesh, rank: int, backend: str) -> None:
        """This rank's coordinates and counts; every subset of the axes of
        size above 1, in one order on every rank, without its group yet."""
        self.mesh, self.rank, self.world = mesh, rank, mesh.size
        self.backend = backend
        self.coords = rank_coords(mesh, rank)
        self.stats = CollectiveStats()
        live = [a for a in mesh.axis_names if mesh.shape[a] > 1]
        self._groups: Dict[Tuple[str, ...], Tuple[object, int]] = {
            axes: (None, math.prod(mesh.shape[a] for a in axes))
            for k in range(1, len(live) + 1)
            for axes in itertools.combinations(live, k)}
        self._keys: Dict[Tuple[str, ...], int] = {}
        self._numbers: list = []
        weakref.finalize(self, _forget, self._numbers)

    def close(self) -> None:
        """Destroys this Comm's sub-groups (the world group stays the
        caller's) and takes its numbers out of `gathered_mm`'s registry."""
        _forget(self._numbers)
        for group, _ in self._groups.values():
            if group is not None and group is not dist.group.WORLD:
                dist.destroy_process_group(group)
        self._groups.clear()
        self._keys.clear()

    # ------------------------------------------------------------- groups

    def _live(self, axes) -> Tuple[str, ...]:
        """`axes` (a name, a tuple of names or None) without the axes of
        size 1; they must come in mesh order."""
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        names = self.mesh.axis_names
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{names}")
        return tuple(a for a in axes if self.mesh.shape[a] > 1)

    def size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in self._live(axes))

    def index(self, axes) -> int:
        """This rank's index in its group over `axes`."""
        return axes_index(self.mesh, self.coords, self._live(axes))

    def group(self, axes):
        """(this rank's group over `axes`, its size); (None, 1) when every
        axis has size 1."""
        live = self._live(axes)
        if not live:
            return None, 1
        return self._groups[live]

    def key(self, axes) -> int:
        """A number that stands for (self, axes) in `gathered_mm`."""
        live = self._live(axes)
        if live not in self._keys:
            k = next(_NUMBERS)
            _GROUPS[k] = (weakref.ref(self), live)
            self._keys[live] = k
            self._numbers.append(k)
        return self._keys[live]

    # ---------------------------------------------------------- execution

    def _run(self, fn, out: torch.Tensor, inp: torch.Tensor, group) -> None:
        """`fn(out, inp, group)`; under gloo a CUDA tensor goes through host
        memory (a copy each way): gloo ranks that share one card."""
        if inp.is_cuda and self.backend == "gloo":
            out_h = torch.empty(out.shape, dtype=out.dtype)
            fn(out_h, inp.cpu(), group)
            out.copy_(out_h)
        else:
            fn(out, inp, group)

    def _count(self, op: str, axes, n: int, in_b: int, out_b: int) -> None:
        self.stats.add(op, n, in_b, out_b)

    def all_gather(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """The blocks of `x` of every member over `axes`, concatenated
        along `dim` in member order."""
        group, n = self.group(axes)
        if n == 1:
            return x
        inp = x.movedim(dim, 0).contiguous()
        out = inp.new_empty((n * inp.shape[0], *inp.shape[1:]))
        self._run(lambda o, i, g: _ALL_GATHER(o, i, group=g), out, inp,
                  group)
        self._count("all-gather", axes, n, _nbytes(inp), _nbytes(out))
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axes) -> torch.Tensor:
        """The sum over the members of `axes`, split along `dim`: this
        rank keeps block `index(axes)`."""
        group, n = self.group(axes)
        if n == 1:
            return x
        inp = x.movedim(dim, 0).contiguous()
        if inp.shape[0] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways")
        out = inp.new_empty((inp.shape[0] // n, *inp.shape[1:]))
        self._run(lambda o, i, g: _REDUCE_SCATTER(o, i, group=g), out, inp,
                  group)
        self._count("reduce-scatter", axes, n, _nbytes(inp), _nbytes(out))
        return out.movedim(0, dim).contiguous()

    def all_reduce(self, x: torch.Tensor, axes,
                   op: str = "sum") -> torch.Tensor:
        """The sum of `x` over the members of `axes` (a new tensor); with
        `op="max"` the elementwise largest."""
        group, n = self.group(axes)
        if n == 1:
            return x
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def fn(o, i, g):
            o.copy_(i)
            dist.all_reduce(o, op=red, group=g)
        self._run(fn, out, x.contiguous(), group)
        self._count("all-reduce", axes, n, _nbytes(x), _nbytes(x))
        return out

    def gather(self, x: torch.Tensor, dst: int = 0):
        """Every rank's `x` (all of one shape) on rank `dst`, a list in rank
        order; None on the other ranks. Under gloo a CUDA tensor goes
        through host memory, and the list is on the host."""
        inp = x.contiguous()
        if inp.is_cuda and self.backend == "gloo":
            inp = inp.cpu()
        outs = [torch.empty_like(inp) for _ in range(self.world)] \
            if self.rank == dst else None
        dist.gather(inp, outs, dst=dst)
        self._count("gather", self.mesh.axis_names, self.world, _nbytes(x),
                    _nbytes(x) * self.world)
        return outs

    def all_to_all(self, x: torch.Tensor, split_dim: int, cat_dim: int,
                   axes) -> torch.Tensor:
        """`x` split along `split_dim` into one block a member, block `j`
        sent to member `j`; the blocks received concatenated along
        `cat_dim` in member order."""
        group, n = self.group(axes)
        if n == 1:
            return x
        inp = torch.stack(x.chunk(n, dim=split_dim), 0).contiguous()
        out = torch.empty_like(inp)
        self._run(lambda o, i, g: dist.all_to_all_single(o, i, group=g),
                  out, inp, group)
        self._count("all-to-all", axes, n, _nbytes(x), _nbytes(x))
        return torch.cat(out.unbind(0), dim=cat_dim)


class PlanComm(Comm):
    """The Comm of rank `rank` of a plan, with no process group: each
    collective makes its output's shape (on `meta`, the dry run's device),
    moves nothing, and is recorded, as the executed step's `Comm` counts
    it, into the active cost trace (`analysis.trace`). So the dry run of a
    step the rules execute traces that step's own collectives."""

    def __init__(self, mesh, rank: int = 0):
        self._setup(mesh, rank, "plan")

    def _run(self, fn, out, inp, group) -> None:
        pass

    def _count(self, op: str, axes, n: int, in_b: int, out_b: int) -> None:
        from repro_torch.analysis import trace
        super()._count(op, axes, n, in_b, out_b)
        tr = trace.active()
        if tr is not None:
            tr._collective(op, self._live(axes), in_b, out_b, "executed")

    def gather(self, x, dst: int = 0):
        raise NotImplementedError("a plan gathers nothing to a rank")

    def close(self) -> None:
        _forget(self._numbers)


# ------------------------------------------------------------- autograd

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, dim, axes):
        ctx.comm, ctx.dim, ctx.axes = comm, dim, axes
        return comm.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return (None, ctx.comm.reduce_scatter(g, ctx.dim, ctx.axes), None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, dim, axes):
        ctx.comm, ctx.dim, ctx.axes = comm, dim, axes
        return comm.reduce_scatter(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_gather(g, ctx.dim, ctx.axes), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, axes):
        return comm.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return None, g, None


class _AllReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_reduce(g, ctx.axes), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, split_dim, cat_dim, axes):
        ctx.comm, ctx.split, ctx.cat, ctx.axes = comm, split_dim, cat_dim, axes
        return comm.all_to_all(x, split_dim, cat_dim, axes)

    @staticmethod
    def backward(ctx, g):
        return (None, ctx.comm.all_to_all(g, ctx.cat, ctx.split, ctx.axes),
                None, None, None)


def all_gather(comm: Comm, x, dim: int, axes):
    """All-gather along `dim`; its backward reduce-scatters."""
    return _AllGather.apply(comm, x, dim, axes)


def reduce_scatter(comm: Comm, x, dim: int, axes):
    """Reduce-scatter along `dim`; its backward all-gathers."""
    return _ReduceScatter.apply(comm, x, dim, axes)


def all_reduce(comm: Comm, x, axes):
    """All-reduce (sum); its backward passes the gradient through."""
    return _AllReduce.apply(comm, x, axes)


def all_reduce_backward(comm: Comm, x, axes):
    """The identity; its backward all-reduces the gradient."""
    return _AllReduceBackward.apply(comm, x, axes)


def all_to_all(comm: Comm, x, split_dim: int, cat_dim: int, axes):
    """All-to-all; its backward is the inverse all-to-all."""
    return _AllToAll.apply(comm, x, split_dim, cat_dim, axes)


# ------------------------------------------------------------ ZeRO-3 product

@torch.library.custom_op("repro_torch::gathered_mm", mutates_args=())
def _gathered_mm(x: torch.Tensor, w: torch.Tensor, dim: int,
                 key: int) -> torch.Tensor:
    comm, axes = _comm_of(key)
    return x @ comm.all_gather(w, dim, axes)


@_gathered_mm.register_fake
def _(x, w, dim, key):
    comm, axes = _comm_of(key)
    n = comm.size(axes)
    last = w.dim() - 1
    return x.new_empty((*x.shape[:-1],
                        w.shape[-1] * (n if dim == last else 1)))


def _gathered_mm_setup(ctx, inputs, output):
    x, w, dim, key = inputs
    ctx.dim, ctx.key = dim, key
    ctx.save_for_backward(x, w)


def _gathered_mm_backward(ctx, g):
    comm, axes = _comm_of(ctx.key)
    x, w = ctx.saved_tensors
    gx = None
    if ctx.needs_input_grad[0]:     # an input from the data needs none
        gx = g @ comm.all_gather(w, ctx.dim, axes).transpose(-1, -2)
    if w.dim() == 2:
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
    else:                       # a batch of products (experts)
        gw = x.transpose(-1, -2) @ g
    return gx, comm.reduce_scatter(gw, ctx.dim, axes), None, None


_gathered_mm.register_autograd(_gathered_mm_backward,
                               setup_context=_gathered_mm_setup)
GATHERED_MM = torch.ops.repro_torch.gathered_mm.default


def gathered_mm(comm: Comm, x, w, dim: int, axes):
    """`x @ w` with `w` sharded along `dim` over `axes`: the whole weight
    gathered for the product and again in the backward where `x` takes a
    gradient, its gradient reduce-scattered back to the shard. `w` is a
    matrix, or a batch of them (E, K, N) that multiplies `x` (E, M, K).
    Without such axes, `x @ w`."""
    if comm.size(axes) == 1:
        return x @ w
    return _gathered_mm(x, w, dim, comm.key(axes))
