"""Mesh axes and their sizes (counterpart: ``ray_tpu/parallel/mesh.py``).

One global mesh whose axes encode every parallelism strategy, in the
reference's order, innermost (heaviest traffic) last:

    (dp, fsdp, ep, pp, sp, tp)

- ``tp``   tensor parallelism: a collective every matmul.
- ``sp``   sequence/context parallelism: ring attention's send/recv.
- ``pp``   pipeline stages: point-to-point activation transfers.
- ``ep``   expert parallelism: all-to-all token routing.
- ``fsdp`` parameter sharding: an all-gather and a reduce-scatter a step.
- ``dp``   pure data parallelism: one gradient all-reduce a step.

``make_mesh`` lays these axes over a torch ``DeviceMesh`` of the ranks
of the default process group, one rank per card (or CPU ranks over gloo
when asked for).  The ``DeviceMesh`` has a dimension only for each axis
of size above 1, in the order above, and one dimension of size 1 named
``"world"`` when every axis has size 1: DTensor's sharding propagation
enumerates placements over the product of the mesh dimensions, so each
dimension, even of size 1, multiplies the host time of every operator's
first call by about eight (``tools/dtensor_mesh_ndim.py``): on a 6-D
mesh a model's first forward stalls for many minutes.
A ``Mesh`` is fully given by its ``DeviceMesh``, so any DTensor's
``device_mesh`` names its axes again.

This module imports torch only inside ``make_mesh``: the trainer's
``ScalingConfig`` carries a ``MeshConfig`` into workers without torch.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_EP = "ep"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_TP = "tp"

MESH_AXES: Tuple[str, ...] = (AXIS_DP, AXIS_FSDP, AXIS_EP, AXIS_PP, AXIS_SP,
                              AXIS_TP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes for the global mesh.  ``-1`` on at most one axis means
    "absorb all remaining devices" (like torch DeviceMesh / maxtext)."""

    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self, n_devices: int) -> Tuple[int, ...]:
        sizes = [self.dp, self.fsdp, self.ep, self.pp, self.sp, self.tp]
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {tuple(sizes)} wants {fixed} devices, have {n_devices}")
        return tuple(sizes)

    @staticmethod
    def auto(n_devices: int,
             prefer: Sequence[str] = (AXIS_TP, AXIS_PP, AXIS_SP, AXIS_EP,
                                      AXIS_FSDP, AXIS_DP)) -> "MeshConfig":
        """Factor ``n_devices`` into powers of two across axes in
        ``prefer`` order (innermost-heaviest first); any leftover factor
        goes to dp."""
        sizes = {a: 1 for a in MESH_AXES}
        rest = n_devices
        for axis in prefer:
            if rest % 2 == 0 and rest > 1:
                sizes[axis] = 2
                rest //= 2
        sizes[AXIS_DP] *= rest
        return MeshConfig(**sizes)


# The DeviceMesh dimension of a mesh whose six axes all have size 1.
WORLD_DIM = "world"

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_mesh", default=None)


class Mesh:
    """The six named axes over a torch ``DeviceMesh`` (counterpart: the
    reference's ``jax.sharding.Mesh``).  ``shape`` maps every axis name to
    its size; ``dim(axis)`` is the axis' ``DeviceMesh`` dimension, or
    ``None`` for an axis of size 1."""

    axis_names = MESH_AXES

    def __init__(self, device_mesh: Any):
        names = tuple(device_mesh.mesh_dim_names or ())
        unknown = [n for n in names if n not in MESH_AXES + (WORLD_DIM,)]
        if unknown:
            raise ValueError(f"mesh dimensions {unknown} are not axes of "
                             f"{MESH_AXES}")
        self.device_mesh = device_mesh
        self._subs: Dict[Tuple[str, ...], "Mesh"] = {}
        self._dims = {a: names.index(a) for a in MESH_AXES if a in names}
        self.shape: Dict[str, int] = {
            a: device_mesh.size(self._dims[a]) if a in self._dims else 1
            for a in MESH_AXES}

    def dim(self, axis: str) -> Optional[int]:
        if axis not in self.shape:
            raise ValueError(f"unknown mesh axis {axis!r}")
        return self._dims.get(axis)

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def sub(self, dims: Tuple[str, ...]) -> "Mesh":
        """The mesh over the ``DeviceMesh`` dimensions ``dims`` alone (the
        other axes at size 1), built once per mesh: slicing reuses the
        dimensions' process groups."""
        names = tuple(self.device_mesh.mesh_dim_names or ())
        if dims == names:
            return self
        if dims not in self._subs:
            self._subs[dims] = Mesh(self.device_mesh[dims])
        return self._subs[dims]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type!r})"


def make_mesh(config: Optional[MeshConfig] = None,
              device_type: Optional[str] = None) -> Mesh:
    """The global mesh over the default process group's ranks, with the
    axis sizes ``config.sizes(world_size)`` (default ``MeshConfig()``:
    every rank on ``dp``).

    ``device_type`` is ``"cuda"`` unless the caller asks for ``"cpu"``:
    on ``cuda`` each rank takes the card at its local index (``LOCAL_RANK``,
    else its rank modulo the card count) and the group must be NCCL; on
    ``cpu`` it must be gloo.  Raises without a process group, and never
    builds a CPU mesh when a card was asked for."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a torch.distributed process "
                           "group: call init_process_group first")
    device_type = device_type or "cuda"
    backend = dist.get_backend()
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh on cuda needs a CUDA device; pass "
                               "device_type='cpu' for a CPU mesh")
        if "nccl" not in backend:
            raise RuntimeError(f"make_mesh on cuda needs an NCCL process "
                               f"group, not {backend!r}")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else
                              dist.get_rank() % torch.cuda.device_count())
    elif device_type == "cpu":
        if "gloo" not in backend:
            raise RuntimeError(f"make_mesh on cpu needs a gloo process "
                               f"group, not {backend!r}")
    else:
        raise ValueError(f"unsupported device type {device_type!r}")
    sizes = (config or MeshConfig()).sizes(dist.get_world_size())
    live = [(a, n) for a, n in zip(MESH_AXES, sizes) if n > 1]
    live = live or [(WORLD_DIM, 1)]
    return Mesh(init_device_mesh(device_type, tuple(n for _, n in live),
                                 mesh_dim_names=tuple(a for a, _ in live)))


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the ambient mesh (the reference's ``jax.set_mesh``)
    for the ``with`` block: ``manual_shard_map`` resolves against it.
    None hides any outer mesh (the body of a region manual over every
    axis of its mesh)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The ambient mesh of ``use_mesh``, or None."""
    return _AMBIENT.get()
