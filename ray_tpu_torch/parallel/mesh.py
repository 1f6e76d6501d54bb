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

This module is arithmetic only and imports no torch.  ``make_mesh``,
which lays these axes over a torch ``DeviceMesh``, comes with ROADMAP.md
Queue 1 item 4.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

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
