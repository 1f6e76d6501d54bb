"""Mixture-of-Experts routing (GShard/Switch-style) for expert
parallelism (counterpart: ``ray_tpu/ops/moe.py``).

Token-choice top-k routing with a fixed expert capacity, as dense
dispatch/combine einsums: static shapes, no data-dependent gather, and
with the expert dimension sharded over ``ep`` the contractions become
collectives over that axis.  The reference computes all of it in XLA with
no Pallas kernel, so the port keeps plain ``torch.einsum``/``matmul``.

Routing is over the global batch, as the reference's: the capacity comes
from the global token count and each expert slot from one cumsum over
every token.  Under a mesh (DTensor inputs) the router logits are
gathered onto every rank and routed there, in a manual region on local
tensors (DTensor has no scatter-add), so each rank holds the whole
batch's dispatch and combine and the aux loss is that of the batch.

Returns the auxiliary load-balancing loss (Switch §2.2 form:
E * sum_e f_e * p_e).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import sys

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.layers import swiglu
from ray_tpu_torch.util import tracing


class MoEOutput(NamedTuple):
    out: torch.Tensor           # (tokens, embed)
    aux_loss: torch.Tensor      # scalar load-balancing loss
    router_probs: torch.Tensor  # (tokens, experts), for metrics


def route_topk(router_logits: torch.Tensor, num_selected: int,
               capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compute (dispatch (T,E,C) f32 0/1, combine (T,E,C) f32, aux_loss).

    Over-capacity tokens are dropped (their combine weights are zero),
    which keeps shapes static.  Choices are ``torch.topk``'s in descending
    order, as ``jax.lax.top_k``'s (ties aside: JAX takes the lower
    index)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, num_selected, dim=-1,
                                       sorted=True)               # (T, k)
    return assign_slots(probs, gate_vals, expert_idx, capacity)


def assign_slots(probs: torch.Tensor, gate_vals: torch.Tensor,
                 expert_idx: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``route_topk`` from its choices: router ``probs`` (T, E) f32, and
    per token its k experts ``expert_idx`` and their ``gate_vals``, best
    first."""
    t, e = probs.shape
    num_selected = expert_idx.shape[1]
    # Position of each (token, choice) in its expert's buffer: running
    # count of earlier assignments to the same expert, over the flattened
    # (choice-major) order, so second choices queue after first choices.
    onehot = F.one_hot(expert_idx, e)                             # (T, k, E)
    flat = onehot.transpose(0, 1).reshape(-1, e)                  # (k*T, E)
    pos_flat = torch.cumsum(flat, dim=0) - flat
    pos = pos_flat.reshape(num_selected, t, e).transpose(0, 1)    # (T, k, E)
    pos = (pos * onehot).sum(-1)                                  # (T, k)
    within = pos < capacity
    if tracing.counting():
        tracing.count("moe.assignments", t * num_selected)
        tracing.count("moe.kept", within.sum())
        tracing.count("moe.slots", e * capacity)

    disp = probs.new_zeros((t, e, capacity))
    comb = torch.zeros_like(disp)
    tok = torch.arange(t, device=probs.device)
    for c in range(num_selected):
        idx = (tok, expert_idx[:, c], pos[:, c].clamp(0, capacity - 1))
        keep = within[:, c].float()
        disp = disp.index_put(idx, keep, accumulate=True)
        comb = comb.index_put(idx, keep * gate_vals[:, c], accumulate=True)

    # Load-balance loss: fraction of tokens per expert x mean router prob.
    density = F.one_hot(expert_idx[:, 0], e).float().mean(0)
    aux = e * (density * probs.mean(0)).sum()
    return disp, comb, aux


def _route(logits: torch.Tensor, num_selected: int, capacity: int):
    """``route_topk`` of the whole batch.  Under a mesh: on every rank,
    from the gathered logits, in a region manual over every axis."""
    # DTensor's module takes a second to import, and the serving path
    # imports ops without it: no DTensor exists before it is imported.
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(logits, dtensor.DTensor):
        return route_topk(logits, num_selected, capacity)
    from ray_tpu_torch.parallel.mesh import MESH_AXES, Mesh
    from ray_tpu_torch.parallel.sharding import P, manual_shard_map

    rep2, rep3 = P(None, None), P(None, None, None)
    return manual_shard_map(
        lambda lg: route_topk(lg, num_selected, capacity), MESH_AXES,
        in_specs=(rep2,), out_specs=(rep3, rep3, P()),
        mesh=Mesh(logits.device_mesh))(logits)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *,
            num_selected: int = 2, capacity_factor: float = 1.25,
            constrain=None) -> MoEOutput:
    """SwiGLU MoE layer.  x: (tokens, embed); router_w: (embed, E);
    w_gate/w_up: (E, embed, mlp); w_down: (E, mlp, embed).

    ``constrain(x, logical_axes)`` optionally applies sharding constraints
    (expert tensors get ('expert', ...), so 'ep' carries the exchange).
    The router logits are in x's dtype and only their softmax in f32;
    dispatch and combine are cast to x's dtype for their einsums, as in
    the reference."""
    t, d = x.shape
    e = router_w.shape[1]
    capacity = max(1, int(capacity_factor * t * num_selected / e))
    with tracing.span("moe.route"):
        logits = x @ router_w.to(x.dtype)
        disp, comb, aux = _route(logits, num_selected, capacity)
    with tracing.span("moe.dispatch"):
        expert_in = torch.einsum("tec,td->ecd", disp.to(x.dtype), x)
        if constrain is not None:
            expert_in = constrain(expert_in, ("expert", None, "embed"))
    with tracing.span("moe.experts"):
        gate = torch.einsum("ecd,edm->ecm", expert_in, w_gate.to(x.dtype))
        up = torch.einsum("ecd,edm->ecm", expert_in, w_up.to(x.dtype))
        act = swiglu(gate, up)
        expert_out = torch.einsum("ecm,emd->ecd", act, w_down.to(x.dtype))
        if constrain is not None:
            expert_out = constrain(expert_out, ("expert", None, "embed"))
    with tracing.span("moe.combine"):
        out = torch.einsum("tec,ecd->td", comb.to(x.dtype), expert_out)
        probs = torch.softmax(logits.float(), dim=-1)
    return MoEOutput(out, aux, probs)
