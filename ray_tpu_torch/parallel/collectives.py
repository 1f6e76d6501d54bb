"""Collectives inside a manual region (counterpart: the ``jax.lax``
collectives the reference calls inside ``shard_map``: ``axis_index``,
``ppermute``, ``all_to_all``, ``psum``).

``sharding.manual_shard_map`` binds each manual axis of its region to
this rank's coordinate on it, the axis' size and its process group
(``bind``); the functions here read that binding.  Each collective is
differentiable, with the reference's transpose:

- ``ppermute``'s backward is the inverse permutation;
- ``all_to_all``'s backward is the all-to-all back;
- ``psum``'s backward is a ``psum`` of the cotangent.  A region's output
  that its spec leaves replicated over a manual axis hands each rank
  ``1/n`` of its cotangent (``manual_shard_map``), so the two together
  give each rank the whole cotangent, as ``jax.grad`` of the reference's
  ``shard_map`` does.

On an axis of size 1 every collective is the identity and calls no group.
A DTensor (a region that leaves other axes under sharding hands its body
DTensors on their sub-mesh) is exchanged through its local tensor, at the
same placements.

A rank must take part in the backward of every collective it ran, or its
peers wait forever; autograd runs a node only when a gradient reaches it.
``touch`` keeps tensors that one rank does not use in the graph with a
zero gradient (the torch form of ``jnp.where``'s and ``lax.cond``'s zero
cotangent).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import sys
from typing import Any, Dict, Iterator, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class BoundAxis:
    """A manual axis as one rank sees it: its coordinate, the axis' size
    and the axis' process group (None at size 1)."""
    index: int
    size: int
    group: Any = None


_BOUND: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_manual_axes", default={})


@contextlib.contextmanager
def bind(axes: Dict[str, BoundAxis]) -> Iterator[None]:
    """Bind ``axes`` for the ``with`` block, on top of the axes already
    bound (an axis bound by an enclosing region keeps that binding)."""
    outer = _BOUND.get()
    token = _BOUND.set({**axes, **outer})
    try:
        yield
    finally:
        _BOUND.reset(token)


def _axis(name: str) -> BoundAxis:
    try:
        return _BOUND.get()[name]
    except KeyError:
        raise NameError(f"unbound axis name: {name!r} (call inside a "
                        f"manual_shard_map region over it)") from None


def axis_index(axis: str) -> int:
    """This rank's coordinate on the bound ``axis``."""
    return _axis(axis).index


def axis_size(axis: str) -> int:
    return _axis(axis).size


def _is_dtensor(x) -> bool:
    # DTensor takes a second to import and the serving path imports ops
    # without it: no DTensor exists before its module is imported.
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _on_local(x, fn):
    """``fn`` of a DTensor's local tensor, at its mesh and placements
    (``fn`` keeps every dimension the placements shard); a plain tensor
    goes straight to ``fn``."""
    if not _is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    y = fn(local).contiguous()
    shape = torch.Size(y.shape[d] * (x.shape[d] // local.shape[d])
                       for d in range(y.dim()))
    return DTensor.from_local(y, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def touch(out: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``out``, with ``others`` in the autograd graph behind it: their
    gradient is zeros.  For a tensor that came from a collective and that
    this rank does not use, so that the rank still runs its backward."""
    live = [o for o in others if o.requires_grad]
    if not live:
        return out
    return _Touch.apply(out, *live)


class _Touch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *others):
        ctx.save_for_backward(*others)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros_like(o) for o in ctx.saved_tensors))


# -- ppermute ---------------------------------------------------------------

def _exchange(xs: Sequence[torch.Tensor], ax: BoundAxis,
              perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Each of ``xs`` sent from axis rank ``src`` to ``dst`` for every pair
    of ``perm``, in one batch of point-to-point operations; a rank no pair
    sends to gets zeros."""
    me = ax.index
    send = [dst for src, dst in perm if src == me]
    recv = [src for src, dst in perm if dst == me]
    xs = [x.contiguous() for x in xs]
    outs = [torch.zeros_like(x) for x in xs]
    ops = []
    for x, out in zip(xs, outs):
        for dst in send:
            if dst == me:
                out.copy_(x)
            else:
                ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(
                    ax.group, dst), ax.group))
        for src in recv:
            if src != me:
                ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                    ax.group, src), ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, perm, *xs):
        ctx.ax, ctx.perm = ax, perm
        return tuple(_exchange(xs, ax, perm))

    @staticmethod
    def backward(ctx, *gs):
        inv = [(dst, src) for src, dst in ctx.perm]
        return (None, None, *_exchange(gs, ctx.ax, inv))


def ppermute(x: Union[torch.Tensor, Sequence[torch.Tensor]], axis: str,
             perm: Sequence[Tuple[int, int]]):
    """``jax.lax.ppermute``: ``x`` (a tensor, or a tuple of tensors sent
    together as one operation) from axis rank ``src`` to ``dst`` for each
    ``(src, dst)`` in ``perm``; a rank that receives nothing gets zeros."""
    ax = _axis(axis)
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    if ax.size == 1:
        return x if single else xs
    perm = tuple((int(s), int(d)) for s, d in perm)
    if len({s for s, _ in perm}) != len(perm) or \
            len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a permutation")
    got = _PPermute.apply(ax, perm, *(t.to_local() if _is_dtensor(t) else t
                                      for t in xs))
    outs = tuple(_like(t, g) for t, g in zip(xs, got))
    return outs[0] if single else outs


def _like(t, local):
    """``local`` at ``t``'s mesh, placements and shape when ``t`` is a
    DTensor."""
    if not _is_dtensor(t):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=contiguous_stride(t.shape))


# -- all_to_all -------------------------------------------------------------

def _all_to_all(x: torch.Tensor, ax: BoundAxis, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = ax.size
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of size "
                         f"{x.shape[split_axis]} does not split over {n}")
    front = x.movedim(split_axis, 0).contiguous()
    got = torch.empty_like(front)
    dist.all_to_all_single(got, front, group=ax.group)
    # got holds the chunks of every source rank in rank order, each with
    # the split dimension in front: put it back, then lay the sources
    # side by side along concat_axis, the first source first.
    chunks = got.reshape(n, front.shape[0] // n, *front.shape[1:])
    chunks = chunks.movedim(1, 1 + split_axis)
    out = chunks.movedim(0, concat_axis)
    shape = list(out.shape)
    shape[concat_axis:concat_axis + 2] = [shape[concat_axis]
                                          * shape[concat_axis + 1]]
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.args = (ax, split_axis, concat_axis)
        return _all_to_all(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ax, split_axis, concat_axis = ctx.args
        return _all_to_all(g, ax, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: chunk i of ``split_axis``
    goes to axis rank i, and the chunks received are concatenated along
    ``concat_axis`` in source-rank order.  A DTensor's placements must
    not shard either dimension."""
    ax = _axis(axis)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if ax.size == 1:
        return x
    if _is_dtensor(x):
        sharded = {p.dim for p in x.placements if p.is_shard()}
        if sharded & {split_axis, concat_axis}:
            raise ValueError(f"all_to_all over {axis!r}: dimensions "
                             f"{split_axis} and {concat_axis} must not be "
                             f"sharded ({x.placements})")
    return _on_local(x, lambda t: _AllToAll.apply(t, ax, split_axis,
                                                  concat_axis))


# -- psum -------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, ax: BoundAxis) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=ax.group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the axis, on every rank of
    it.  Its backward is a psum of the cotangent (see the module
    docstring)."""
    ax = _axis(axis)
    if ax.size == 1:
        return x
    return _on_local(x, lambda t: _PSum.apply(t, ax))
