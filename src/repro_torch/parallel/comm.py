"""Collectives of the plan's manual regions, as autograd Functions.

The port's counterpart of what ``shard_map`` does for the JAX package at a
region's edge, and of the ``psum``/``all_gather`` inside it, and of the
layout GSPMD keeps for sharded parameters (parallel/sharding.py). Outside
a region the ranks of the tp and sp dims compute the same thing on whole
tensors; over the data dims each rank holds its own rows under the
training layout (whole, replicated rows otherwise). A region takes this
rank's shard of some axes, runs the kernels on it, and hands back whole
tensors. Each op takes the mesh dims it acts over as
:class:`~repro_torch.parallel.sharding.Axis` records (explicit process
groups, from the DeviceMesh); a dim of width 1 is skipped. Forward and
backward, under replicated compute outside the region:

========================  ====================  ===========================
op                        forward               backward
========================  ====================  ===========================
:func:`split`             this rank's slice     all-gather the slices
:func:`gather`            all-gather            this rank's slice (no sum)
:func:`copy`              identity              all-reduce (sum)
:func:`all_gather_tiled`  all-gather            all-reduce, then the slice
:func:`psum`              all-reduce (sum)      all-reduce (sum)
:func:`reduce`            all-reduce (sum)      identity
========================  ====================  ===========================

``split``: a region input sharded over some dims (heads over tp, sequence
over sp, batch over data). ``gather``: the region's output. ``copy``: an
operand every shard reads whole (a shared E/F, the slot buffers over sp,
the router), whose gradient sums over the dims that divide the work.
``all_gather_tiled``: sp's compressed prefix k̄/v̄, which each shard then
uses for different queries. ``psum``: a sum whose result feeds different
work on each rank (the exact form's k̄/v̄, weight-stationary MoE's h and
g). ``reduce``: a sum that every rank then uses alike (MoE's sum of
expert groups).

Only ``all_gather`` (the list form) and ``all_reduce`` are issued: the two
collectives every backend, gloo included, supports (gloo takes CUDA
tensors too). ``BYTES`` counts, per op, the bytes of every collective it
issues, forward and backward: the whole gathered tensor of an all-gather,
the tensor of an all-reduce, i.e. what one rank receives; ``CALLS`` counts
the collectives themselves. ``DIM_BYTES`` and ``DIM_CALLS`` count the same
by the mesh dim they run over, ``OP_DIM_BYTES`` by (op, mesh dim).

Tensor parallelism (models/layers.py, models/attention.py, the head and
cross-entropy, models/mamba2.py and models/rwkv6.py) runs on two of
these, Megatron's pair: ``copy`` where the stream enters a
column-parallel matmul and ``reduce`` after a row-parallel one. Its
collectives are then all-reduces of activations over the model dim (and
the cross-entropy's row maxima, Mamba2's gated norm's sums of squares),
but for the two column-parallel leaves whose shard does not line up with
a rank's heads, Mamba2's ``ssm/w_in`` and RWKV6's ``cm_w_r``
(sharding.column_matmul): each gathers either the leaf or its output
over the model dim, whichever is smaller. No other parameter is gathered
over it.
"""
from __future__ import annotations

import collections
from typing import Sequence

import torch
import torch.distributed as dist

BYTES: collections.Counter = collections.Counter()
CALLS: collections.Counter = collections.Counter()
DIM_BYTES: collections.Counter = collections.Counter()
DIM_CALLS: collections.Counter = collections.Counter()
OP_DIM_BYTES: collections.Counter = collections.Counter()


def reset_counters() -> None:
    for c in (BYTES, CALLS, DIM_BYTES, DIM_CALLS, OP_DIM_BYTES):
        c.clear()


def _count(op: str, axis, y: torch.Tensor) -> None:
    n = y.numel() * y.element_size()
    BYTES[op] += n
    CALLS[op] += 1
    DIM_BYTES[axis.name] += n
    DIM_CALLS[axis.name] += 1
    OP_DIM_BYTES[(op, axis.name)] += n


def _live(axes) -> tuple:
    return tuple(a for a in axes if a is not None and a.width > 1)


def flat_width(axes) -> int:
    n = 1
    for a in _live(axes):
        n *= a.width
    return n


def flat_coord(axes) -> int:
    """This rank's index along the product of `axes`, the first major (the
    order in which :func:`split` takes slices)."""
    i = 0
    for a in _live(axes):
        i = i * a.width + a.coord
    return i


def _all_reduce(x: torch.Tensor, axis, op: str) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=axis.group)
    _count(op, axis, y)
    return y


def _all_gather(x: torch.Tensor, dim: int, axis, op: str) -> torch.Tensor:
    y = x.detach().contiguous()
    if y.is_floating_point() and y.element_size() == 1:
        # fp8 codes travel as their bytes (gloo has no fp8 type)
        return _all_gather(y.view(torch.uint8), dim, axis, op).view(y.dtype)
    parts = [torch.empty_like(y) for _ in range(axis.width)]
    dist.all_gather(parts, y, group=axis.group)
    out = torch.cat(parts, dim=dim)
    _count(op, axis, out)
    return out


def _slice(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    n = x.shape[dim]
    if n % axis.width != 0:
        raise ValueError(f"dim {dim} of size {n} does not split over mesh "
                         f"axis {axis.name!r} ({axis.width} shards)")
    n //= axis.width
    return x.narrow(dim, axis.coord * n, n).contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _slice(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.axis, "split"), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis, "gather")

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.axis), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = _all_reduce(g, a, "copy")
        return g, None


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis, "all_gather")

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.axis, "all_gather")
        return _slice(g, ctx.dim, ctx.axis), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        for a in axes:
            x = _all_reduce(x, a, "psum")
        return x

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = _all_reduce(g, a, "psum")
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        for a in axes:
            x = _all_reduce(x, a, "reduce")
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def split(x: torch.Tensor, dim: int, axes: Sequence) -> torch.Tensor:
    """This rank's slice of `dim`, split over `axes` (the first major)."""
    for a in _live(axes):
        x = _Split.apply(x, dim, a)
    return x


def gather(x: torch.Tensor, dim: int, axes: Sequence) -> torch.Tensor:
    """The whole tensor from every rank's slice of `dim` (inverse of
    :func:`split` over the same `axes`)."""
    for a in reversed(_live(axes)):
        x = _Gather.apply(x, dim, a)
    return x


def copy(x: torch.Tensor, axes: Sequence) -> torch.Tensor:
    """`x` as is; its gradient sums over `axes`. Integer tensors (no
    gradient) pass through untouched."""
    axes = _live(axes)
    if not axes or not x.is_floating_point():
        return x
    return _Copy.apply(x, axes)


def all_gather_tiled(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """The shards of `axis` concatenated along `dim` in axis order; the
    gradient sums over the ranks, then takes this rank's slice."""
    if axis is None or axis.width == 1:
        return x
    return _AllGatherTiled.apply(x, dim, axis)


def amax(x: torch.Tensor, axes: Sequence) -> torch.Tensor:
    """The elementwise max of `x` over `axes` (no gradient): each rank's
    tensor all-gathered, then the max (a 0-d tensor: the max of the
    ranks' values; the vocabulary-parallel cross-entropy: each row's max
    over the shards)."""
    y = x.detach()
    for a in _live(axes):
        y = _all_gather(y[None], 0, a, "amax").amax(0)
    return y


def all_gather_stack(x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's `x` along `axis`, stacked on a new leading dim in axis
    order (no gradient); `x` alone when the dim is absent or 1 wide."""
    if axis is None or axis.width == 1:
        return x.detach()[None]
    return _all_gather(x[None], 0, axis, "stack")


def psum(x: torch.Tensor, axes: Sequence) -> torch.Tensor:
    """Sum over `axes`; the gradient sums too."""
    axes = _live(axes)
    return _Psum.apply(x, axes) if axes else x


def reduce(x: torch.Tensor, axes: Sequence) -> torch.Tensor:
    """Sum over `axes`; the gradient passes through."""
    axes = _live(axes)
    return _Reduce.apply(x, axes) if axes else x
