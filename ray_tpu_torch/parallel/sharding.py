"""Logical-axis sharding rules over DTensor (counterpart:
``ray_tpu/parallel/sharding.py``).

Model code names tensor dimensions *logically* ("batch", "embed",
"heads", "expert", ...); one rules table maps logical names to mesh axes,
so swapping the table re-shards the whole model (DP-only, FSDP, 2-D
fsdp x tp, MoE over ``ep``) without touching model code.  A logical
spec becomes DTensor placements on the mesh's ``DeviceMesh``: a tensor
dimension sharded over a mesh axis is ``Shard(d)`` on that axis'
dimension, and every other ``DeviceMesh`` dimension is ``Replicate()``.
Axes of size 1 have no ``DeviceMesh`` dimension and drop out.

Conventions of the port, where the reference has global jax arrays:

- a plain tensor handed to a sharded function holds the same global value
  on every rank (``shard_pytree`` takes each rank's shard of it locally,
  with no communication);
- ``with_logical_constraint`` is a ``redistribute``: DTensor inserts the
  collectives that XLA's partitioner inserts in the reference;
- ``manual_shard_map`` runs a function on each rank's shards, manual
  over some axes and under sharding over the others.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (
    DTensor, Partial, Placement, Replicate, Shard, distribute_tensor)

from ray_tpu_torch.parallel.collectives import (
    BoundAxis, bind, contiguous_stride)
from ray_tpu_torch.parallel.mesh import (
    AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP, MESH_AXES, Mesh,
    current_mesh, use_mesh)

# A logical axis maps to one mesh axis, a tuple of mesh axes (dimension
# sharded over their product), or None (replicated).
MeshAxes = Union[None, str, Tuple[str, ...]]
LogicalAxisRules = Dict[str, MeshAxes]

# Megatron-style 2D sharding + MoE + sequence parallelism.  Batch is split
# over (dp, fsdp): fsdp behaves as extra data parallelism for activations
# while sharding parameters ZeRO-3 style on their "embed"-like dimension.
DEFAULT_RULES: LogicalAxisRules = {
    "batch": (AXIS_DP, AXIS_FSDP),
    "seq": AXIS_SP,               # sequence/context parallelism (ring attn)
    "embed": None,                # activation embed dim stays replicated
    "heads": AXIS_TP,             # attention heads over tensor axis
    "kv_heads": AXIS_TP,
    "head_dim": None,
    "mlp": AXIS_TP,               # ffn hidden: column-parallel then row-parallel
    "vocab": AXIS_TP,             # embedding/vocab-parallel output head
    "kernel_in": AXIS_FSDP,       # ZeRO-3: param input dim over fsdp
    "expert": AXIS_EP,            # MoE experts over expert axis
    "stage": AXIS_PP,             # pipeline stages (stacked-stage layout)
    "layer": None,                # scanned-layer leading dim (non-pipelined)
}


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one tensor: ``None``, an axis name, or a
    tuple of axis names (the dimension sharded over their product, the
    first the major one).  A tuple, so it compares equal to the entries
    of the reference's ``PartitionSpec``."""

    def __new__(cls, *entries: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)}"


P = PartitionSpec


def logical_to_mesh_axes(logical_axes: Sequence[Optional[str]],
                         rules: Optional[LogicalAxisRules] = None
                         ) -> PartitionSpec:
    """('batch','seq','embed') -> P(('dp','fsdp'),'sp',None).

    Mesh axes already consumed by an earlier dimension are dropped (a mesh
    axis can shard at most one dimension of a given tensor)."""
    rules = DEFAULT_RULES if rules is None else rules
    used = set()
    out: List[MeshAxes] = []
    for name in logical_axes:
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return P(*out)


def _named(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one ``PartitionSpec`` entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(mesh: Mesh, spec: Sequence[MeshAxes]
                    ) -> Tuple[Placement, ...]:
    """A ``PartitionSpec`` -> one placement per ``DeviceMesh`` dimension.
    A dimension over several axes is ``Shard(d)`` on each of them; they
    must be in mesh order (DTensor splits the first mesh dimension
    first, as JAX orders the product)."""
    out: List[Placement] = [Replicate()] * mesh.device_mesh.ndim
    for d, entry in enumerate(spec):
        axes = _named(entry)
        if list(axes) != sorted(axes, key=MESH_AXES.index):
            raise ValueError(f"dimension {d} is sharded over {axes}, out of "
                             f"the mesh order {MESH_AXES}")
        for a in axes:
            dim = mesh.dim(a)
            if dim is None:
                continue                          # an axis of size 1
            if not isinstance(out[dim], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dimensions")
            out[dim] = Shard(d)
    return tuple(out)


def placements(mesh: Mesh, *logical_axes: Optional[str],
               rules: Optional[LogicalAxisRules] = None
               ) -> Tuple[Placement, ...]:
    """The DTensor placements of a tensor with these logical axes (the
    reference's ``named_sharding``)."""
    return spec_placements(mesh, logical_to_mesh_axes(logical_axes, rules))


def with_logical_constraint(x: Any, logical_axes: Sequence[Optional[str]],
                            mesh: Optional[Mesh] = None,
                            rules: Optional[LogicalAxisRules] = None) -> Any:
    """Redistribute the DTensor ``x`` to the placements of its logical
    axes on ``mesh``, else the ambient mesh, else its own.  A plain
    tensor (no mesh) comes back unchanged."""
    if not isinstance(x, DTensor):
        return x
    mesh = mesh or current_mesh() or Mesh(x.device_mesh)
    return x.redistribute(mesh.device_mesh,
                          placements(mesh, *logical_axes, rules=rules))


def _shard(x: torch.Tensor, mesh: Mesh, spec: Sequence[MeshAxes]):
    """``x`` at the placements of ``spec``: a DTensor is redistributed; a
    plain tensor, the same global value on every rank, is cut into this
    rank's shard locally (no communication)."""
    pl = spec_placements(mesh, spec)
    if isinstance(x, DTensor):
        return x.redistribute(mesh.device_mesh, pl)
    return distribute_tensor(x.to(mesh.device_type), mesh.device_mesh, pl,
                             src_data_rank=None)


def shard_pytree(tree: Any, spec_tree: Any, mesh: Mesh,
                 rules: Optional[LogicalAxisRules] = None) -> Any:
    """A nested dict of tensors -> DTensors at the placements of the
    matching dict of logical-axis tuples (e.g. a model's
    ``param_logical_axes``)."""
    if isinstance(tree, dict):
        return {k: shard_pytree(v, spec_tree[k], mesh, rules)
                for k, v in tree.items()}
    return _shard(tree, mesh, logical_to_mesh_axes(spec_tree, rules))


def sharding_tree(spec_tree: Any, mesh: Mesh,
                  rules: Optional[LogicalAxisRules] = None) -> Any:
    """A nested dict of logical-axis tuples -> the same dict of DTensor
    placements."""
    if isinstance(spec_tree, dict):
        return {k: sharding_tree(v, mesh, rules)
                for k, v in spec_tree.items()}
    return placements(mesh, *spec_tree, rules=rules)


def _tree_map(fn: Callable, arg: Any, spec: Any) -> Any:
    """``fn(leaf, leaf_spec)`` over a dict of tensors and a matching dict
    of specs; one ``PartitionSpec`` stands for every leaf below it (the
    reference's spec prefixes)."""
    if isinstance(spec, PartitionSpec):
        if isinstance(arg, dict):
            return {k: _tree_map(fn, v, spec) for k, v in arg.items()}
        return fn(arg, spec)
    return {k: _tree_map(fn, arg[k], spec[k]) for k in spec}


def _spec_leaves(spec: Any) -> List[PartitionSpec]:
    if isinstance(spec, PartitionSpec):
        return [spec]
    return [s for v in spec.values() for s in _spec_leaves(v)]


def _no_partial(pl: Sequence[Placement]) -> List[Placement]:
    """Placements for a gradient: a pending sum is reduced (DTensor's own
    rule for the gradient of a ``Partial`` tensor)."""
    return [Replicate() if p.is_partial() else p for p in pl]


class _Region:
    """One call of a region manual over ``manual`` on ``mesh``.  The
    ``DeviceMesh`` dimensions of the other axes (``free``) stay under
    sharding: the body sees DTensors on their sub-mesh (``inner``), or
    plain local tensors when none is left.  A dimension of size 1 named
    ``WORLD_DIM`` counts as manual."""

    def __init__(self, mesh: Mesh, manual: frozenset):
        self.mesh, self.manual = mesh, manual
        names = tuple(mesh.device_mesh.mesh_dim_names or ())
        self.free = tuple(i for i, n in enumerate(names)
                          if n in MESH_AXES and n not in manual)
        self.inner = (mesh.sub(tuple(names[i] for i in self.free))
                      if self.free else None)

    def bound(self) -> Dict[str, BoundAxis]:
        dm, out = self.mesh.device_mesh, {}
        for a in self.manual:
            d = self.mesh.dim(a)
            out[a] = (BoundAxis(0, 1) if d is None else BoundAxis(
                dm.get_local_rank(d), dm.size(d), dm.get_group(d)))
        return out

    def _check(self, spec, shape, pl_free, what):
        for d, entry in enumerate(spec):
            n = math.prod(self.mesh.shape[a] for a in _named(entry))
            if shape[d] % n:
                raise ValueError(f"dimension {d} of size {shape[d]} does "
                                 f"not split evenly over {entry}")
            if n > 1 and any(p.is_shard(d) for p in pl_free):
                raise ValueError(
                    f"dimension {d} of the {what} is sharded over a manual "
                    f"axis ({entry}) and over a free one ({pl_free}): a "
                    f"strided shard, not supported")

    def _scale(self, spec) -> List[int]:
        """Per tensor dimension, the product of the manual axes' sizes
        that ``spec`` shards it over."""
        return [math.prod(self.mesh.shape[a] for a in _named(e))
                for e in spec]

    def enter(self, x: torch.Tensor, spec: PartitionSpec):
        dm = self.mesh.device_mesh
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x.to(self.mesh.device_type), dm,
                                   [Replicate()] * dm.ndim, run_check=False)
        spec = tuple(spec) + (None,) * (x.dim() - len(spec))
        target = list(spec_placements(self.mesh, spec))
        for i in self.free:
            target[i] = x.placements[i]
        self._check(spec, x.shape, [target[i] for i in self.free],
                    "argument")
        return _Enter.apply(x.redistribute(dm, target), self, spec)

    def exit(self, o: torch.Tensor, spec: PartitionSpec):
        spec = tuple(spec) + (None,) * (o.dim() - len(spec))
        full = list(spec_placements(self.mesh, spec))
        sub = (list(o.placements) if isinstance(o, DTensor)
               else [Replicate()] * len(self.free))
        for j, i in enumerate(self.free):
            full[i] = sub[j]
        self._check(spec, [0] * o.dim(), sub, "output")
        shape = torch.Size(n * k for n, k in zip(o.shape, self._scale(spec)))
        # The spec leaves the output replicated over these manual
        # dimensions: each rank takes 1/n of its cotangent (see
        # collectives.py).
        dm = self.mesh.device_mesh
        left = math.prod(dm.size(i) for i in range(dm.ndim)
                         if i not in self.free and full[i].is_replicate())
        return _Exit.apply(o, self, tuple(full), shape, left)


class _Enter(torch.autograd.Function):
    """A DTensor at the region's placements -> what the body sees.  The
    gradient goes back at the input's placements, summed over the manual
    axes its spec leaves out (``Partial`` on them): the reference's
    transpose of ``shard_map`` for an input that is replicated over an
    axis but used differently by the axis' ranks."""

    @staticmethod
    def forward(ctx, x, region, spec):
        ctx.region, ctx.spec = region, spec
        ctx.meta = (x.placements, x.shape)
        local = x.to_local().contiguous()
        local = local.view_as(local)
        if region.inner is None:
            return local
        shape = torch.Size(n // k for n, k in zip(x.shape,
                                                  region._scale(spec)))
        return DTensor.from_local(
            local, region.inner.device_mesh,
            [x.placements[i] for i in region.free], run_check=False,
            shape=shape, stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        region = ctx.region
        placements, shape = ctx.meta
        dm = region.mesh.device_mesh
        gpl = [p if p.is_shard() or dm.size(i) == 1 else Partial()
               for i, p in enumerate(spec_placements(region.mesh, ctx.spec))]
        if isinstance(g, DTensor):
            for j, i in enumerate(region.free):
                gpl[i] = g.placements[j]
            g = g.to_local()
        else:
            for i in region.free:
                gpl[i] = Replicate()
        full = DTensor.from_local(g.contiguous(), dm, gpl, run_check=False,
                                  shape=shape,
                                  stride=contiguous_stride(shape))
        return full.redistribute(dm, _no_partial(placements)), None, None


class _Exit(torch.autograd.Function):
    """What the body returned -> a DTensor on the region's mesh at the
    output spec's placements (and the body's own on the free dimensions).
    The cotangent goes back divided by the sizes of the manual axes the
    spec leaves out."""

    @staticmethod
    def forward(ctx, o, region, full, shape, left):
        ctx.region, ctx.full, ctx.left = region, full, left
        ctx.sub = ((o.placements, o.shape)
                   if isinstance(o, DTensor) else None)
        local = (o.to_local() if isinstance(o, DTensor) else o).contiguous()
        return DTensor.from_local(
            local.view_as(local), region.mesh.device_mesh, full,
            run_check=False, shape=shape, stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        region = ctx.region
        g = g.redistribute(region.mesh.device_mesh,
                           _no_partial(ctx.full)).to_local().contiguous()
        if ctx.left != 1:
            g = g / ctx.left
        if ctx.sub is not None:
            placements, shape = ctx.sub
            g = DTensor.from_local(g, region.inner.device_mesh,
                                   _no_partial(placements), run_check=False,
                                   shape=shape,
                                   stride=contiguous_stride(shape))
        return g, None, None, None, None


def manual_shard_map(f: Callable, axis_names, in_specs, out_specs,
                     mesh: Optional[Mesh] = None) -> Callable:
    """``f`` run on each rank's shards, manual over ``axis_names`` (the
    reference's ``shard_map`` with ``axis_names``).

    Each argument is brought to the placements of its ``PartitionSpec``
    in ``in_specs`` on the manual axes (an argument may be a dict of
    tensors, with a dict of specs or one spec for all its leaves).  The
    other axes of the mesh stay under sharding: ``f`` gets a DTensor on
    the sub-mesh of their ``DeviceMesh`` dimensions, at the argument's
    placements there, or its plain local tensor when no such dimension is
    left.  Inside ``f`` that sub-mesh is the ambient mesh (None when there
    is none) and the manual axes are bound for ``collectives``.  Each
    output of ``f`` (a tensor, or a tuple when ``out_specs`` is a tuple of
    specs) becomes a DTensor on the mesh at its spec.  Specs may name only
    ``axis_names``, and each sharded dimension must split evenly.

    The region is differentiable with the reference's transpose: an
    input's gradient is summed over the manual axes its spec leaves out
    (so a rank that does not use a replicated input still gets the whole
    gradient), and an output replicated over manual axes hands each rank
    its cotangent divided by their size.

    The mesh is the ambient one (``use_mesh``) when there is one, else
    ``mesh``."""
    axis_names = frozenset(axis_names)
    single = isinstance(out_specs, PartitionSpec)
    outs = (out_specs,) if single else tuple(out_specs)
    for spec in [s for t in in_specs for s in _spec_leaves(t)] + list(outs):
        for entry in spec:
            if not set(_named(entry)) <= axis_names:
                raise ValueError(f"spec {spec} names axes outside the manual "
                                 f"axes {sorted(axis_names)}")

    def call(*args):
        use = current_mesh() or mesh
        if use is None:
            raise ValueError("manual_shard_map needs an ambient mesh "
                             "(use_mesh) or an explicit mesh argument")
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             f"in_specs")
        region = _Region(use, axis_names)
        local = [_tree_map(region.enter, a, s)
                 for a, s in zip(args, in_specs)]
        with bind(region.bound()), use_mesh(region.inner):
            got = f(*local)
        got = (got,) if single else tuple(got)
        if len(got) != len(outs):
            raise ValueError(f"{len(got)} outputs for {len(outs)} out_specs")
        res = tuple(region.exit(o, s) for o, s in zip(got, outs))
        return res[0] if single else res

    return call
