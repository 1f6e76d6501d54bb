"""Flash attention, forward and backward: the hand-written CUDA kernels
K1-K3 and their plain PyTorch versions (counterpart:
``ray_tpu/ops/attention.py``).

- K1 (``csrc/flash_fwd.cu``) replaces the Pallas ``_fwd_kernel``: a
  log2-domain online softmax over kv tiles, q pre-scaled by
  ``sm_scale*log2(e)`` and rounded back to q's dtype before the kernel (as
  the reference does), fully masked causal tiles skipped, ``o = acc/l``
  and ``lse = m + log2(l)``.
- K2 and K3 (``csrc/flash_bwd.cu``) replace ``_dkdv_kernel`` and
  ``_dq_kernel``: both recompute ``p = exp2(s - lse)`` from the saved
  log2-domain lse, round ``p`` and ``ds = p*(dp - delta)`` to the input
  dtype before the grad products, accumulate in f32, and scale dk by
  ``ln 2`` and dq by ``sm_scale`` at the end.  ``delta = rowsum(o*do)``,
  which the reference leaves to XLA, is computed in K3's prologue on the
  card (K3 runs first and hands it to K2), and by ``_delta`` on the CPU.

One ``torch.autograd.Function`` on the unscaled q (the reference's
``custom_vjp`` on ``_flash``) holds all three: CUDA tensors launch the
kernels, CPU tensors run the plain versions below, which follow the same
algorithm block by block and are what the kernels are held against on the
card.  The kernels mask ragged sequence tails themselves, so there is no
``_fit_block`` fallback to ``mha_reference``: on CUDA the kernels always
run, and what they do not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.layers import repeat_kv_heads
from ray_tpu_torch.parallel.collectives import contiguous_stride

NEG_INF = -1e30  # finite "minus infinity": keeps exp() NaN-free on masked rows
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_KERNEL = "flash_fwd"
_BWD_LIB = "flash_bwd"
# The plain versions' kv blocks: K1's BLOCK_N (p is rounded to bf16
# relative to the running max, so the plain forward takes its max over the
# same columns), and K2's/K3's tile width.
_FWD_BLOCK_N = 128
_PLAIN_BLOCK_K = 64
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = (_P,) * 5 + (_I,) * 7 + (_P,)
_DQ_ARGS = (_P,) * 8 + (_I,) * 7 + (ctypes.c_float, _P)
_DKDV_ARGS = (_P,) * 8 + (_I,) * 7 + (_P,)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Plain multi-head attention, the numerics oracle.  q: (b, sq, h, d),
    k/v: (b, sk, h, d); scores and softmax in f32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        qi = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        ki = kv_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def per_shard(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``fn(q, k, v)``, an attention over q's heads (k and v repeated to
    them), on each rank's local shards when q is a DTensor: a shard over
    batch (dim 0) or heads (dim 2) stays, as attention keeps them apart;
    any other placement is gathered first.  The output comes back at the
    same placements.  Plain tensors go straight to ``fn``."""
    # The serving path imports ops without DTensor, which takes a second
    # to import: no DTensor exists before it is imported.
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(q, dtensor.DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    pl = [p if p.is_shard(0) or p.is_shard(2) else dtensor.Replicate()
          for p in q.placements]
    q, k, v = (x.redistribute(mesh, pl) for x in (q, k, v))
    o = fn(q.to_local(), k.to_local(), v.to_local()).contiguous()
    return dtensor.DTensor.from_local(o, mesh, pl, run_check=False,
                                      shape=q.shape,
                                      stride=contiguous_stride(q.shape))


def _prescale(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """``q * (sm_scale*log2(e))`` rounded back to q's dtype, with the same
    bits as the reference's ``(q * c).astype(q.dtype)`` (attention.py:321):
    there the Python float ``c`` is weakly typed and becomes a constant of
    q's dtype before the product, so it is rounded to q's dtype here too."""
    return (q * _prescale_const(sm_scale, q.dtype)).to(q.dtype)


@functools.lru_cache(maxsize=64)
def _prescale_const(sm_scale: float, dtype: torch.dtype) -> float:
    """``sm_scale*log2(e)`` rounded to ``dtype`` (a host tensor, once per
    scale and dtype)."""
    return float(torch.tensor(sm_scale * _LOG2E, dtype=dtype))


def _flash_fwd_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 on pre-scaled q, k/v already at q's head count:
    the same log2-domain online softmax over kv blocks.  Returns
    ``(o (b, sq, h, d) in q's dtype, lse (b, h, sq) f32, log2 domain)``."""
    b, sq, h, d = qs.shape
    sk = k.shape[1]
    qf = qs.float().transpose(1, 2)                          # (b, h, sq, d)
    kf = k.float().transpose(1, 2)
    vt = v.transpose(1, 2)
    rows = torch.arange(sq, device=qs.device)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=qs.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=qs.device)
    for k0 in range(0, sk, _FWD_BLOCK_N):
        k1 = min(k0 + _FWD_BLOCK_N, sk)
        s = qf @ kf[:, :, k0:k1].transpose(-1, -2)           # (b, h, sq, bk)
        if causal:
            cols = torch.arange(k0, k1, device=qs.device)[None, :]
            s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        p = torch.exp2(s - m_next)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vt[:, :, k0:k1].float()
        m = m_next
    o = (acc / l).to(qs.dtype).transpose(1, 2)
    lse = (m + torch.log2(l))[..., 0]
    return o, lse


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(o*do)`` in f32, (b, h, sq): the reference computes it
    outside its kernels (attention.py:272-274).  The CPU path's delta and
    the oracle of K3's prologue, which computes it on the card."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_blocks(qs, k, v, do, lse, delta, causal):
    """The recompute both plain backward kernels share, per kv block of
    ``_PLAIN_BLOCK_K``: yields ``(k0, k1, p, ds)`` with ``p = exp2(s -
    lse)`` f32 and ``ds = p*(dp - delta)`` rounded to q's dtype, both
    (b, h, sq, bk); masked entries are exactly 0."""
    sq, sk = qs.shape[1], k.shape[1]
    qf = qs.float().transpose(1, 2)                          # (b, h, sq, d)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    dof = do.float().transpose(1, 2)
    rows = torch.arange(sq, device=qs.device)[:, None]
    for k0 in range(0, sk, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, sk)
        s = qf @ kf[:, :, k0:k1].transpose(-1, -2)           # (b, h, sq, bk)
        if causal:
            cols = torch.arange(k0, k1, device=qs.device)[None, :]
            s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
        p = torch.exp2(s - lse[..., None])
        dp = dof @ vf[:, :, k0:k1].transpose(-1, -2)
        yield k0, k1, p, (p * (dp - delta[..., None])).to(qs.dtype)


def _flash_dkdv_plain(qs, k, v, do, lse, delta, causal
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 on pre-scaled q, k/v at q's head count: per kv
    block, ``dv = p^T do`` with p in do's dtype and ``dk = ln2 * ds^T qs``,
    f32 accumulation.  Returns ``(dk, dv)`` (b, sk, h, d) in k's and v's
    dtypes."""
    dof = do.float().transpose(1, 2)
    qf = qs.float().transpose(1, 2)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    for k0, k1, p, ds in _bwd_blocks(qs, k, v, do, lse, delta, causal):
        dv[:, k0:k1] = (p.to(do.dtype).float().transpose(-1, -2)
                        @ dof).transpose(1, 2)
        dk[:, k0:k1] = (ds.float().transpose(-1, -2)
                        @ qf).transpose(1, 2) * _LN2
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_dq_plain(qs, k, v, do, lse, delta, causal,
                    sm_scale: float) -> torch.Tensor:
    """Plain version of K3: ``dq = sm_scale * sum over kv blocks of
    ds k`` with ds in q's dtype, f32 accumulation.  Returns dq
    (b, sq, h, d) in q's dtype (the gradient of the UNSCALED q)."""
    kf = k.float().transpose(1, 2)
    dq = torch.zeros(qs.transpose(1, 2).shape, dtype=torch.float32,
                     device=qs.device)
    for k0, k1, _, ds in _bwd_blocks(qs, k, v, do, lse, delta, causal):
        dq += ds.float() @ kf[:, :, k0:k1]
    return (dq * sm_scale).to(qs.dtype).transpose(1, 2)


def _sum_kv_groups(x: torch.Tensor, h_kv: int) -> torch.Tensor:
    """(b, s, h, d) gradient at q's head count -> (b, s, h_kv, d): the
    transpose of ``repeat_kv_heads`` (q head i reads kv head i // group)."""
    b, s, h, d = x.shape
    if h == h_kv:
        return x
    return x.reshape(b, s, h_kv, h // h_kv, d).sum(3)


def _check_cuda_inputs(lib, q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(lib, name, x, q.device, torch.bfloat16)
        if x.dim() != 4:
            raise ValueError(f"{name} must be a contiguous (b, s, h, d) "
                             f"tensor, got shape {tuple(x.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if d not in (32, 64, 128):
        raise ValueError(f"flash kernel takes head_dim 32, 64 or 128, got {d}")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")


def _flash_fwd_cuda(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream.  k/v keep their own (GQA) head
    count: the kernel maps each q head to its kv head."""
    _check_cuda_inputs(_KERNEL, qs, k, v)
    b, sq, h, d = qs.shape
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    _build.launch(_KERNEL, "rtt_flash_fwd_bf16", _FWD_ARGS, qs.device,
                  qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b, h, k.shape[2], sq, k.shape[1], d,
                  int(causal))
    return o, lse


def _check_cuda_grad_inputs(qs, k, v, like_q, rows):
    """``like_q``: name -> tensor that must match q (do, o); ``rows``:
    name -> f32 (b, h, sq) tensor (lse, delta).  A wrong dtype of these is
    a ValueError, as their other faults are."""
    _check_cuda_inputs(_BWD_LIB, qs, k, v)
    b, sq, h, _ = qs.shape
    for names, dtype, shape in ((like_q, qs.dtype, qs.shape),
                                (rows, torch.float32, (b, h, sq))):
        for name, x in names.items():
            if x.dtype != dtype:
                raise ValueError(f"{name} must be a contiguous {dtype} "
                                 f"tensor of shape {tuple(shape)}")
            _build.check_operand(_BWD_LIB, name, x, qs.device, dtype, shape)


def _flash_dkdv_cuda(qs, k, v, do, lse, delta, causal
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (after K3, which writes ``delta``): dk, dv at k/v's own
    (GQA) head count; each block sums over the q heads of its kv head."""
    _check_cuda_grad_inputs(qs, k, v, {"do": do},
                            {"lse": lse, "delta": delta})
    b, sq, h, d = qs.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch(_BWD_LIB, "rtt_flash_dkdv_bf16", _DKDV_ARGS, qs.device,
                  qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, h, k.shape[2], sq, k.shape[1], d,
                  int(causal))
    return dk, dv


def _flash_dq_cuda(qs, k, v, o, do, lse, causal, sm_scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3, the first kernel of the backward: dq (b, sq, h, d), the
    gradient of the unscaled q, and ``delta = rowsum(o*do)`` (b, h, sq)
    f32, computed in its prologue, for K2."""
    _check_cuda_grad_inputs(qs, k, v, {"o": o, "do": do}, {"lse": lse})
    b, sq, h, d = qs.shape
    dq = torch.empty_like(qs)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    _build.launch(_BWD_LIB, "rtt_flash_dq_bf16", _DQ_ARGS, qs.device,
                  qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), b, h, k.shape[2], sq, k.shape[1], d,
                  int(causal), sm_scale)
    return dq, delta


class _Flash(torch.autograd.Function):
    """Flash attention on the UNSCALED q, as the reference's custom VJP
    (attention.py:319-341): the pre-scale is inside the node and treated
    as exact, so dq is ``sm_scale * ds k``.  Returns ``(o, lse)``; lse is
    not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        qs = _prescale(q, sm_scale)
        if q.is_cuda:
            o, lse = _flash_fwd_cuda(qs, k, v, causal)
        else:
            o, lse = _flash_fwd_plain(qs, *repeat_kv_heads(q, k, v), causal)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qs, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if qs.is_cuda:
            dq, delta = _flash_dq_cuda(qs, k, v, o, do, lse, ctx.causal,
                                       ctx.sm_scale)
            dk, dv = _flash_dkdv_cuda(qs, k, v, do, lse, delta, ctx.causal)
        else:
            delta = _delta(o, do)
            k2, v2 = repeat_kv_heads(qs, k, v)
            dk, dv = _flash_dkdv_plain(qs, k2, v2, do, lse, delta,
                                       ctx.causal)
            dq = _flash_dq_plain(qs, k2, v2, do, lse, delta, ctx.causal,
                                 ctx.sm_scale)
            dk, dv = (_sum_kv_groups(x, k.shape[2]) for x in (dk, dv))
        return dq, dk, dv, None, None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward.  q: (b, sq, h, d); k/v: (b, sk, h_kv, d)
    with ``h % h_kv == 0``.  Returns ``(o, lse)``: o (b, sq, h, d) in q's
    dtype and lse (b, h, sq) f32 in the log2 domain (scores pre-scaled by
    ``sm_scale*log2(e)``).

    CUDA tensors always launch the kernel K1, and K2/K3 in the backward
    (bfloat16, head_dim 32/64/128, any sequence lengths: ragged tails are
    masked in the kernels); what they do not take raises.  CPU tensors
    take the plain versions."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    return _Flash.apply(q, k, v, causal, sm_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Memory-efficient MHA.  q: (b, sq, h, d); k/v: (b, sk, h_kv, d).
    Grouped-query attention when k/v have fewer heads than q.  See
    ``flash_attention_fwd`` for what runs where."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)[0]
