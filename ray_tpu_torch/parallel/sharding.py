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
- ``manual_shard_map`` runs a function on each rank's local shards.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (
    DTensor, Placement, Replicate, Shard, distribute_tensor)

from ray_tpu_torch.parallel.mesh import (
    AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP, MESH_AXES, Mesh,
    current_mesh)

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


def manual_shard_map(f: Callable, axis_names, in_specs, out_specs,
                     mesh: Optional[Mesh] = None) -> Callable:
    """``f`` run on each rank's local shards (the reference's shard_map,
    manual over ``axis_names``).  Each argument is brought to the
    placements of its ``PartitionSpec`` in ``in_specs`` and handed to
    ``f`` as its local tensor; each output of ``f`` (a tensor, or a tuple
    when ``out_specs`` is a tuple of specs) becomes a DTensor at its spec
    in ``out_specs``.  Specs may name only ``axis_names``, and each
    sharded dimension must split evenly.  A mesh axis a spec leaves out
    replicates the tensor over it: every rank of that axis computes the
    same values, and its output gradient, redistributed to the same
    placements, gives each the same input gradient.  The region is
    differentiable.

    The mesh is the ambient one (``use_mesh``) when there is one, else
    ``mesh``."""
    axis_names = set(axis_names)
    single = isinstance(out_specs, PartitionSpec)
    outs = (out_specs,) if single else tuple(out_specs)
    for spec in tuple(in_specs) + outs:
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
        local = []
        for a, s in zip(args, in_specs):
            for d, entry in enumerate(s):
                if a.shape[d] % math.prod(use.shape[x]
                                          for x in _named(entry)):
                    raise ValueError(f"dimension {d} of size {a.shape[d]} "
                                     f"does not split evenly over {entry}")
            local.append(_shard(a, use, s).to_local())
        got = f(*local)
        got = (got,) if single else tuple(got)
        if len(got) != len(outs):
            raise ValueError(f"{len(got)} outputs for {len(outs)} out_specs")
        res = tuple(DTensor.from_local(o, use.device_mesh,
                                       spec_placements(use, s),
                                       run_check=False)
                    for o, s in zip(got, outs))
        return res[0] if single else res

    return call
