"""Flash attention forward: the hand-written CUDA kernel K1 and its plain
PyTorch version (counterpart: ``ray_tpu/ops/attention.py``).

The kernel (``csrc/flash_fwd.cu``) replaces the Pallas kernel
``_fwd_kernel``: a log2-domain online softmax over kv tiles, q pre-scaled
by ``sm_scale*log2(e)`` and rounded back to q's dtype before the kernel
(as the reference does), fully masked causal tiles skipped, ``o = acc/l``
and ``lse = m + log2(l)``.  The plain version below emulates the same
algorithm block by block in PyTorch; it is what runs for CPU tensors and
what the kernel is held against on the card.

Unlike the reference, the kernel masks ragged sequence tails itself, so
there is no ``_fit_block`` fallback to ``mha_reference``: on CUDA the
kernel always runs.  The backward kernels (the reference's
``_dkdv_kernel``/``_dq_kernel``) are the next slice of the port; until
then the CUDA path has no gradient, while the CPU path stays
differentiable by autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.layers import repeat_kv_heads

NEG_INF = -1e30  # finite "minus infinity": keeps exp() NaN-free on masked rows
_LOG2E = 1.4426950408889634
_KERNEL = "flash_fwd"
# The plain version's kv block (the kernel's tile width).
_PLAIN_BLOCK_K = 64


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


def _prescale(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    # Rounded back to q's dtype: the kernel and its plain version see the
    # same bits, as in the reference (attention.py:321).
    return (q * (sm_scale * _LOG2E)).to(q.dtype)


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
    for k0 in range(0, sk, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, sk)
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


def _check_cuda_inputs(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bfloat16, {name} is "
                            f"{x.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
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
    _check_cuda_inputs(qs, k, v)
    b, sq, h, d = qs.shape
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    fn = _build.function(
        _KERNEL, "rtt_flash_fwd_bf16",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    with torch.cuda.device(qs.device):
        err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, k.shape[2], sq, k.shape[1], d,
                 int(causal), stream)
    _build.launches[_KERNEL] += 1
    _build.check_launch(_KERNEL, err)
    return o, lse


class _FlashFwd(torch.autograd.Function):
    """K1 as an autograd node.  Its backward is the next slice of the
    port (K2 ``_dkdv_kernel`` and K3 ``_dq_kernel``)."""

    @staticmethod
    def forward(ctx, qs, k, v, causal):
        return _flash_fwd_cuda(qs, k, v, causal)

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash attention backward on CUDA needs kernels K2 (_dkdv_kernel) "
            "and K3 (_dq_kernel), which are the next slice of the port")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward.  q: (b, sq, h, d); k/v: (b, sk, h_kv, d)
    with ``h % h_kv == 0``.  Returns ``(o, lse)``: o (b, sq, h, d) in q's
    dtype and lse (b, h, sq) f32 in the log2 domain (scores pre-scaled by
    ``sm_scale*log2(e)``).

    CUDA tensors always launch the kernel K1 (bfloat16, head_dim 32/64/128,
    any sequence lengths: ragged tails are masked in the kernel); what it
    does not take raises.  CPU tensors take the plain version."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qs = _prescale(q, sm_scale)
    if q.is_cuda:
        return _FlashFwd.apply(qs, k, v, causal)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    k, v = repeat_kv_heads(q, k, v)
    return _flash_fwd_plain(qs, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Memory-efficient MHA.  q: (b, sq, h, d); k/v: (b, sk, h_kv, d).
    Grouped-query attention when k/v have fewer heads than q.  See
    ``flash_attention_fwd`` for what runs where."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)[0]
