"""Mixture-of-Experts routing (GShard/Switch-style) for expert
parallelism (counterpart: ``ray_tpu/ops/moe.py``).

Token-choice top-k routing with a fixed expert capacity.  ``assign``
turns the top-k choices into index tables: each (token, choice)'s slot in
its expert's buffer, kept while its position is under the capacity, and
each slot's (token, choice).  A position is the running count of earlier
assignments to the same expert over the choice-major order, so second
choices queue after every first choice; it comes from a stable sort by
expert.  The tables have T·k and E·C entries, so no shape depends on the
data and the host never waits.

Two paths, chosen by the inputs:

- Local tensors (the trainer's world-1 step): the tables drive the
  dispatch, a gather of token rows into the (E, C, d) expert buffer, and
  the combine, each token's gate-weighted sum of its kept slots.  Each is
  a ``torch.autograd.Function`` whose backward is the other's gather.
  CUDA tensors launch K6 (``csrc/moe.cu``: ``rtt_moe_gather``,
  ``rtt_moe_combine``); CPU tensors take the plain versions.
- DTensor inputs, or a ``constrain``: the reference's dense dispatch and
  combine einsums over (T, E, C) tensors built from the same tables; with
  the expert dimension sharded over ``ep`` the contractions become
  collectives over that axis.  Routing is over the global batch, as the
  reference's: the router logits are gathered onto every rank and routed
  there, in a manual region on local tensors (DTensor has no
  scatter-add), so each rank holds the whole batch's dispatch and combine
  and the aux loss is that of the batch.

Returns the auxiliary load-balancing loss (Switch §2.2 form:
E * sum_e f_e * p_e).
"""

from __future__ import annotations

import ctypes
import sys
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.layers import swiglu
from ray_tpu_torch.util import tracing

_KERNEL = "moe"
_P, _I = ctypes.c_void_p, ctypes.c_int
_GATHER_ARGS = (_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P)
_COMBINE_ARGS = (_P, _P, _I, _P, _P, _I, _I, _I, _P)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}   # csrc/moe.cu's codes


class MoEOutput(NamedTuple):
    out: torch.Tensor           # (tokens, embed)
    aux_loss: torch.Tensor      # scalar load-balancing loss
    router_probs: torch.Tensor  # (tokens, experts), for metrics


class Routing(NamedTuple):
    """One routed batch of T tokens over E experts of capacity C."""
    probs: torch.Tensor    # (T, E) f32 router probabilities
    gates: torch.Tensor    # (T, k) f32, each token's top-k probabilities
    experts: torch.Tensor  # (T, k) int64, their experts, best first
    keep: torch.Tensor     # (T, k) bool, within the expert's capacity
    slot: torch.Tensor     # (T, k) int32, expert * C + position; -1 dropped
    source: torch.Tensor   # (E * C,) int32, token * k + choice; -1 empty
    aux: torch.Tensor      # scalar load-balancing loss


def assign(probs: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
           capacity: int) -> Routing:
    """The slot tables of router ``probs`` (T, E) f32 and, per token, its
    k choices ``experts`` and their ``gates``, best first."""
    t, e = probs.shape
    k = experts.shape[1]
    dev = experts.device
    flat = experts.t().reshape(-1)                    # (k*T,) choice-major
    ordered, order = torch.sort(flat, stable=True)
    first = torch.searchsorted(ordered, torch.arange(e, device=dev))
    rank = torch.arange(k * t, device=dev) - first[ordered]
    pos = torch.empty_like(flat).scatter_(0, order, rank)
    pos = pos.view(k, t).t().contiguous()             # (T, k)
    keep = pos < capacity
    slots = e * capacity
    slot = torch.where(keep, experts * capacity + pos, -1)
    # Dropped choices all write to one spare entry past the end.
    source = torch.full((slots + 1,), -1, dtype=torch.int32, device=dev)
    source.scatter_(0, torch.where(keep, slot, slots).view(-1),
                    torch.arange(t * k, dtype=torch.int32, device=dev))
    if tracing.counting():
        tracing.count("moe.assignments", t * k)
        tracing.count("moe.kept", keep.sum())
        tracing.count("moe.slots", slots)
    # Load-balance loss: fraction of tokens per expert x mean router prob.
    density = F.one_hot(experts[:, 0], e).float().mean(0)
    aux = e * (density * probs.mean(0)).sum()
    return Routing(probs, gates, experts, keep, slot.to(torch.int32),
                   source[:slots], aux)


def route(router_logits: torch.Tensor, num_selected: int,
          capacity: int) -> Routing:
    """Softmax in f32, top-k choices, then ``assign``.  Choices are
    ``torch.topk``'s in descending order, as ``jax.lax.top_k``'s (ties
    aside: JAX takes the lower index)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gates, experts = torch.topk(probs, num_selected, dim=-1, sorted=True)
    return assign(probs, gates, experts, capacity)


def dense(r: Routing) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dispatch (T, E, C) f32 0/1 and combine (T, E, C)
    f32 of a routing.  A dropped choice writes its 0 into its expert's
    last slot, never another choice's of the same token (the k experts
    of a token differ)."""
    t, e = r.probs.shape
    capacity = r.source.numel() // e
    col = torch.where(r.keep, r.slot.long(),
                      r.experts * capacity + capacity - 1)
    keep = r.keep.float()
    disp = r.probs.new_zeros((t, e * capacity)).scatter(1, col, keep)
    comb = torch.zeros_like(disp).scatter(1, col, keep * r.gates)
    return disp.view(t, e, capacity), comb.view(t, e, capacity)


def route_topk(router_logits: torch.Tensor, num_selected: int,
               capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compute (dispatch (T,E,C) f32 0/1, combine (T,E,C) f32, aux_loss).

    Over-capacity tokens are dropped (their combine weights are zero),
    which keeps shapes static."""
    r = route(router_logits, num_selected, capacity)
    return (*dense(r), r.aux)


def _is_dtensor(t: torch.Tensor) -> bool:
    # DTensor's module takes a second to import, and the serving path
    # imports ops without it: no DTensor exists before it is imported.
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(t, dtensor.DTensor)


def _route(logits: torch.Tensor, num_selected: int, capacity: int):
    """``route_topk`` of the whole batch.  Under a mesh: on every rank,
    from the gathered logits, in a region manual over every axis."""
    if not _is_dtensor(logits):
        return route_topk(logits, num_selected, capacity)
    from ray_tpu_torch.parallel.mesh import MESH_AXES, Mesh
    from ray_tpu_torch.parallel.sharding import P, manual_shard_map

    rep2, rep3 = P(None, None), P(None, None, None)
    return manual_shard_map(
        lambda lg: route_topk(lg, num_selected, capacity), MESH_AXES,
        in_specs=(rep2,), out_specs=(rep3, rep3, P()),
        mesh=Mesh(logits.device_mesh))(logits)


# -- K6: the dispatch's and the combine's row movers -------------------------

def gather(src: torch.Tensor, source: torch.Tensor, k: int,
           w: Optional[torch.Tensor] = None,
           b: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Slot-major: ``out[s] = w[a] · src[a // k]`` for the (token,
    choice) ``a = source[s]`` (w: 1 when None), zeros where ``source[s]``
    is -1; (S, d) in src's dtype, the product in f32.  With ``b`` (S, d):
    also ``dot[s] = <src[a // k], b[s]>`` in f32, 0 at an empty slot.
    CUDA tensors launch ``rtt_moe_gather``, CPU tensors the plain
    version."""
    if src.is_cuda:
        return _gather_cuda(src, source, k, w, b)
    return _gather_plain(src, source, k, w, b)


def combine(src: torch.Tensor, slot: torch.Tensor,
            w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-major: ``out[t] = Σ_c w[t, c] · src[slot[t, c]]`` over the
    choices c with ``slot[t, c] >= 0``, in order (w: 1 when None), summed
    in f32 and stored in src's dtype: (T, d).  CUDA tensors launch
    ``rtt_moe_combine``, CPU tensors the plain version."""
    if src.is_cuda:
        return _combine_cuda(src, slot, w)
    return _combine_plain(src, slot, w)


def _gather_plain(src, source, k, w, b):
    full = (source >= 0)[:, None]
    a = source.long().clamp(min=0)
    rows = src.index_select(0, a // k).float()
    scaled = rows if w is None else rows * w.reshape(-1)[a].float()[:, None]
    out = torch.where(full, scaled, 0.0).to(src.dtype)
    dot = None
    if b is not None:
        dot = torch.where(full, rows * b.float(), 0.0).sum(-1)
    return out, dot


def _combine_plain(src, slot, w):
    t, k = slot.shape
    rows = src.index_select(0, slot.long().clamp(min=0).view(-1)).view(
        t, k, -1).float()
    acc = torch.zeros((t, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    for c in range(k):
        term = rows[:, c] if w is None else rows[:, c] * w[:, c, None].float()
        acc = acc + torch.where(slot[:, c, None] >= 0, term, 0.0)
    return acc.to(src.dtype)


def _rows(what: str, src: torch.Tensor) -> int:
    """Checks the dtype and width of a row operand; returns its code."""
    if src.dtype not in _DTYPES:
        raise TypeError(f"K6 takes bfloat16 or float32 rows; {what} is "
                        f"{src.dtype}")
    if src.dim() != 2 or src.shape[1] % 8:
        raise ValueError(f"K6 takes (rows, d) with d a multiple of 8; "
                         f"{what} has shape {tuple(src.shape)}")
    return _DTYPES[src.dtype]


def _ptr(what: str, t: Optional[torch.Tensor], dev: torch.device, dtype,
         shape) -> Optional[int]:
    """A K6 operand's address (None for an absent one), after the shared
    check; every K6 operand is read in 16-byte vectors."""
    if t is None:
        return None
    return _build.check_operand(_KERNEL, what, t, dev, dtype, shape,
                                aligned=True)


def _gather_cuda(src, source, k, w, b):
    dev = src.device
    code = _rows("src", src)
    n, d = src.shape
    s = source.numel()
    args = (_ptr("src", src, dev, src.dtype, (n, d)),
            _ptr("source", source, dev, torch.int32, (s,)), k,
            _ptr("w", w, dev, src.dtype, (n, k)),
            _ptr("b", b, dev, src.dtype, (s, d)))
    out = torch.empty((s, d), dtype=src.dtype, device=dev)
    dot = None if b is None else torch.empty(s, dtype=torch.float32,
                                             device=dev)
    _build.launch(_KERNEL, "rtt_moe_gather", _GATHER_ARGS, dev, *args,
                  None if dot is None else dot.data_ptr(), out.data_ptr(),
                  s, d, code)
    return out, dot


def _combine_cuda(src, slot, w):
    dev = src.device
    code = _rows("src", src)
    d = src.shape[1]
    t, k = slot.shape
    args = (_ptr("src", src, dev, src.dtype, src.shape),
            _ptr("slot", slot, dev, torch.int32, (t, k)), k,
            _ptr("w", w, dev, src.dtype, (t, k)))
    out = torch.empty((t, d), dtype=src.dtype, device=dev)
    _build.launch(_KERNEL, "rtt_moe_combine", _COMBINE_ARGS, dev, *args,
                  out.data_ptr(), t, d, code)
    return out


class _Dispatch(torch.autograd.Function):
    """x (T, d) -> the expert buffer (E·C, d): each slot's token row,
    zeros where empty.  Backward: each token's sum of its kept slots'
    grads."""

    @staticmethod
    def forward(ctx, x, source, slot):
        ctx.save_for_backward(slot)
        return gather(x.contiguous(), source, slot.shape[1])[0]

    @staticmethod
    def backward(ctx, grad):
        slot, = ctx.saved_tensors
        return combine(grad.contiguous(), slot), None, None


class _Combine(torch.autograd.Function):
    """The expert outputs (E·C, d) and the kept gates ``w`` (T, k) in
    x's dtype -> each token's weighted sum (T, d).  Backward: each slot's
    token grad times its gate, and each kept gate's grad, the f32 dot of
    its token's grad with its slot's output, in one gather."""

    @staticmethod
    def forward(ctx, y, w, source, slot):
        y = y.contiguous()
        ctx.save_for_backward(y, w, source, slot)
        return combine(y, slot, w)

    @staticmethod
    def backward(ctx, grad):
        y, w, source, slot = ctx.saved_tensors
        want_w = ctx.needs_input_grad[1]
        grad_y, dot = gather(grad.contiguous(), source, slot.shape[1], w=w,
                             b=y if want_w else None)
        grad_w = None
        if want_w:
            grad_w = torch.where(slot >= 0, dot[slot.long().clamp(min=0)],
                                 0.0).to(w.dtype)
        return grad_y, grad_w, None, None


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *,
            num_selected: int = 2, capacity_factor: float = 1.25,
            constrain=None) -> MoEOutput:
    """SwiGLU MoE layer.  x: (tokens, embed); router_w: (embed, E);
    w_gate/w_up: (E, embed, mlp); w_down: (E, mlp, embed).

    ``constrain(x, logical_axes)`` optionally applies sharding constraints
    (expert tensors get ('expert', ...), so 'ep' carries the exchange).
    The router logits are in x's dtype and only their softmax in f32; the
    gates are rounded to x's dtype before they weight the combine, as the
    reference's combine tensor is."""
    t, d = x.shape
    e = router_w.shape[1]
    capacity = max(1, int(capacity_factor * t * num_selected / e))
    with tracing.span("moe.route"):
        logits = x @ router_w.to(x.dtype)
        r = None
        if constrain is None and not _is_dtensor(logits):
            r = route(logits, num_selected, capacity)
            aux = r.aux
        else:
            disp, comb, aux = _route(logits, num_selected, capacity)
    with tracing.span("moe.dispatch"):
        if r is not None:
            expert_in = _Dispatch.apply(x, r.source, r.slot).view(
                e, capacity, d)
        else:
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
        if r is not None:
            out = _Combine.apply(expert_out.reshape(e * capacity, d),
                                 (r.keep * r.gates).to(x.dtype), r.source,
                                 r.slot)
            probs = r.probs
        else:
            out = torch.einsum("tec,ecd->td", comb.to(x.dtype), expert_out)
            probs = torch.softmax(logits.float(), dim=-1)
    return MoEOutput(out, aux, probs)
