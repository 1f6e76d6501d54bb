"""Ring attention: sequence parallelism over the 'sp' mesh axis
(counterpart: ``ray_tpu/ops/ring_attention.py``).

Each rank holds a contiguous sequence chunk of q/k/v.  The k/v chunks go
around the ring with ``collectives.ppermute`` while every rank
accumulates the attention of its local q against each visiting chunk
with streaming softmax stats ``(m, l, acc)``: flash attention blocked at
the mesh level.  Every step is plain torch (einsums, ``exp``, the merge),
as the reference computes it in XLA outside any Pallas kernel, so it
carries no kernel of its own; autograd gives the ring backward, as AD
does for the reference.

Causal masking is exact: at step ``t`` rank ``i`` holds kv chunk
``(i - t) mod n``; a chunk above the diagonal costs no math (a Python
branch on the rank's index, where the reference takes ``lax.cond``), the
diagonal chunk is masked elementwise.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import NEG_INF, per_shard
from ray_tpu_torch.ops.layers import repeat_kv_heads
from ray_tpu_torch.parallel.collectives import (
    axis_index, axis_size, ppermute, touch)
from ray_tpu_torch.parallel.mesh import AXIS_SP, Mesh


def _chunk_attn(q, k, v, sm_scale, causal, same_chunk):
    """Unnormalized attention of local q against one kv chunk: (m, l,
    acc), the rowmax, the rowsum of exp and the weighted values, f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal and same_chunk:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    m = s.amax(dim=-1)                                   # (b, h, q)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return m, l, acc


def _ring_local(q, k, v, sm_scale, causal, axis_name):
    n = axis_size(axis_name)
    me = axis_index(axis_name)
    b, sq, h, _ = q.shape
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for t in range(n):
        kv_idx = (me - t) % n
        if causal and kv_idx > me:
            # Above the diagonal: no math.  k and v stay in the graph with
            # a zero gradient, so this rank still runs the backward of
            # the rotations that brought them.
            m_c = touch(torch.full_like(m, NEG_INF), k, v)
            l_c, acc_c = torch.zeros_like(l), torch.zeros_like(acc)
        else:
            m_c, l_c, acc_c = _chunk_attn(q, k, v, sm_scale, causal,
                                          kv_idx == me)
        m_new = torch.maximum(m, m_c)
        a_prev = torch.exp(m - m_new)
        a_cur = torch.exp(m_c - m_new)
        l = l * a_prev + l_c * a_cur
        acc = (acc * a_prev.transpose(1, 2)[..., None]
               + acc_c * a_cur.transpose(1, 2)[..., None])
        m = m_new
        if t + 1 < n:         # the last rotation's result is unused
            k, v = ppermute((k, v), axis_name, perm)
    l = l.transpose(1, 2)[..., None]                     # (b, q, h, 1)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _ring_attention_sharded(q, k, v, sm_scale, causal, axis_name):
    """The ring inside a region manual over ``axis_name`` (k and v with
    q's heads)."""
    return per_shard(functools.partial(
        _ring_local, sm_scale=sm_scale, causal=causal, axis_name=axis_name),
        q, k, v)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, sm_scale: Optional[float] = None,
                   mesh: Optional[Mesh] = None,
                   axis_name: str = AXIS_SP) -> torch.Tensor:
    """Sequence-parallel attention.  q/k/v: (b, seq, h, d), seq sharded
    over ``axis_name``.  Call inside a region manual over it (mesh=None),
    or pass a mesh for a region of its own (q, k, v then DTensors or
    plain tensors holding the global value on every rank; the output a
    DTensor).

    K/V with fewer heads (GQA) are broadcast to q's head count first.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    k, v = repeat_kv_heads(q, k, v)
    if mesh is None:
        return _ring_attention_sharded(q, k, v, sm_scale, causal, axis_name)
    from ray_tpu_torch.parallel.sharding import P, manual_shard_map
    spec = P(None, axis_name, None, None)
    fn = manual_shard_map(
        lambda q_, k_, v_: _ring_attention_sharded(
            q_, k_, v_, sm_scale, causal, axis_name),
        {axis_name}, in_specs=(spec, spec, spec), out_specs=spec, mesh=mesh)
    return fn(q, k, v)
