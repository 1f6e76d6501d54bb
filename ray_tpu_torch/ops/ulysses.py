"""Ulysses (DeepSpeed-style) sequence parallelism: all-to-all head
sharding (counterpart: ``ray_tpu/ops/ulysses.py``).

The other sequence-parallel strategy beside ring attention: two
``collectives.all_to_all`` calls re-shard q/k/v from sequence-sharded to
head-sharded, full attention runs per head group, and one more shards the
output back:

    (b, s/n, h, d)  --all_to_all-->  (b, s, h/n, d)  --attn-->  --back-->

With ``use_flash`` the attention is the port's ``flash_attention``: the
kernel K1 on a CUDA tensor, and K2/K3 in its backward.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import (
    flash_attention, mha_reference, per_shard)
from ray_tpu_torch.ops.layers import repeat_kv_heads
from ray_tpu_torch.parallel.collectives import all_to_all, axis_size
from ray_tpu_torch.parallel.mesh import AXIS_SP, Mesh


def _ulysses_local(q, k, v, sm_scale, causal, axis_name, use_flash):
    n = axis_size(axis_name)
    if q.shape[2] % n:
        raise ValueError(f"ulysses: {q.shape[2]} heads (on this rank) do "
                         f"not split over {axis_name}={n}")

    # (b, s_local, h, d) -> (b, s_global, h_local, d) and back.
    def scatter_heads(x):
        return all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    def gather_heads(x):
        return all_to_all(x, axis_name, split_axis=1, concat_axis=2)

    q, k, v = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    if use_flash:
        # The kernel takes contiguous (b, s, h, d) tensors.
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, sm_scale=sm_scale)
    else:
        o = mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return gather_heads(o)


def _ulysses_sharded(q, k, v, sm_scale, causal, axis_name, use_flash):
    """Ulysses inside a region manual over ``axis_name`` (k and v with
    q's heads)."""
    return per_shard(functools.partial(
        _ulysses_local, sm_scale=sm_scale, causal=causal,
        axis_name=axis_name, use_flash=use_flash), q, k, v)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, sm_scale: Optional[float] = None,
                      mesh: Optional[Mesh] = None, axis_name: str = AXIS_SP,
                      use_flash: bool = True) -> torch.Tensor:
    """All-to-all sequence-parallel attention.  q/k/v: (b, seq, h, d)
    with seq sharded over ``axis_name``; h must be divisible by the axis
    size.  ``mesh`` as for ``ring_attention``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    k, v = repeat_kv_heads(q, k, v)
    if mesh is None:
        return _ulysses_sharded(q, k, v, sm_scale, causal, axis_name,
                                use_flash)
    if q.shape[2] % mesh.shape[axis_name]:
        raise ValueError(f"ulysses: {q.shape[2]} heads do not split over "
                         f"{axis_name}={mesh.shape[axis_name]}")
    from ray_tpu_torch.parallel.sharding import P, manual_shard_map
    spec = P(None, axis_name, None, None)
    fn = manual_shard_map(
        lambda q_, k_, v_: _ulysses_sharded(q_, k_, v_, sm_scale, causal,
                                            axis_name, use_flash),
        {axis_name}, in_specs=(spec, spec, spec), out_specs=spec, mesh=mesh)
    return fn(q, k, v)
