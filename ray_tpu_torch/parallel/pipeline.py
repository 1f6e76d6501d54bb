"""Pipeline parallelism: the GPipe schedule over the 'pp' mesh axis
(counterpart: ``ray_tpu/parallel/pipeline.py``).

Transformer layers are split into ``pp`` contiguous stages; each rank of
the 'pp' axis holds one stage's weights, and microbatches flow around the
ring with ``collectives.ppermute`` carrying activations from stage to
stage.  The region is manual only over 'pp' (``manual_axes``), so the
other axes stay under sharding inside the stage: the pipeline composes
with them.  The schedule is plain GPipe, as the reference's: ``M + n - 1``
steps (a fill and drain bubble of ``n - 1`` steps), a Python loop where
the reference scans; autograd gives the backward (the ppermutes' inverse
permutations), as AD does there.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Shard

from ray_tpu_torch.parallel.collectives import (
    axis_index, ppermute, psum, touch)
from ray_tpu_torch.parallel.mesh import AXIS_PP, Mesh
from ray_tpu_torch.parallel.sharding import P, PartitionSpec, manual_shard_map


def _tree(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *,
                   mesh: Mesh, num_microbatches: int,
                   axis_name: str = AXIS_PP,
                   manual_axes: Optional[set] = None,
                   x_spec: PartitionSpec = P()) -> torch.Tensor:
    """Run ``x`` through ``pp`` stages of ``stage_fn``.

    stage_params: a dict of tensors whose leading dimension is the stage
    (``split_stages``); each 'pp' rank gets its stage's slice.
    x: (batch, ...) activations, the batch divisible by
    ``num_microbatches``; ``stage_fn(params_for_stage, x_mb) -> y_mb`` of
    the same shape.

    ``manual_axes``/``x_spec``: more axes bound in the same region (for
    example 'sp' with a seq-sharded ``x_spec`` for ring attention inside
    the stages).

    Every step runs the stage, the bubble steps on zeros (rank 0 takes
    microbatch ``clip(t, 0, M-1)``, the others what the previous stage
    sent); the last stage's outputs of steps ``n-1 .. n-1+M-1`` are
    summed over 'pp' with the other ranks' masked to zero, so the result
    is replicated over 'pp'.
    """
    manual_axes = set(manual_axes or {axis_name})
    n = mesh.shape[axis_name]
    if n == 1 and manual_axes == {axis_name}:
        return stage_fn(_tree(lambda p: p[0], stage_params), x)
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} % microbatches {num_microbatches} != 0")
    m = num_microbatches
    # A batch sharded over other axes stays sharded on the rows of each
    # microbatch: the schedule takes the microbatches one by one.
    x_mb = _move_shard(x.reshape((m, b // m) + tuple(x.shape[1:])), 0, 1)

    def body(params, xs):
        # Each pp rank's stage slice keeps a leading stage dim of 1.
        params = _tree(lambda p: p[0], params)
        idx = axis_index(axis_name)
        steps = m + n - 1
        perm = [(i, (i + 1) % n) for i in range(n)]
        fresh = xs.unbind(0)
        buf = torch.zeros_like(fresh[0])
        outs = []
        for t in range(steps):
            take = fresh[min(t, m - 1)]
            # Both stay in the graph (jnp.where's zero cotangent), so
            # every rank runs the backward of every ppermute.
            inp = touch(take, buf) if idx == 0 else touch(buf, take)
            out = stage_fn(params, inp)
            outs.append(out)
            if t + 1 < steps:     # the last step's rotation is unused
                buf = ppermute(out, axis_name, perm)
        outs = torch.stack(outs[n - 1:n - 1 + m])
        mask = 1.0 if idx == n - 1 else 0.0
        return psum(outs * mask, axis_name)

    mb_spec = P(None, *x_spec)    # the microbatch dim prepended
    y_mb = manual_shard_map(
        body, manual_axes, in_specs=(P(axis_name), mb_spec),
        out_specs=mb_spec, mesh=mesh)(stage_params, x_mb)
    return _move_shard(y_mb, 1, 0).reshape(x.shape)


def _move_shard(x, src: int, dst: int):
    """A DTensor's shards of dimension ``src`` moved to ``dst``."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Shard(dst) if p.is_shard(src)
                                          else p for p in x.placements])


def split_stages(layer_params: Any, num_stages: int) -> Any:
    """Reshape stacked-layer params (L, ...) -> (pp, L/pp, ...)."""
    def rs(p):
        n = p.shape[0]
        if n % num_stages:
            raise ValueError(f"{n} layers not divisible by {num_stages} "
                             f"stages")
        return p.reshape((num_stages, n // num_stages) + tuple(p.shape[1:]))
    return _tree(rs, layer_params)
