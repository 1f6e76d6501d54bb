"""Paged (block-table) decode attention: the hand-written CUDA kernel K4
and its plain PyTorch version (counterpart:
``ray_tpu/ops/paged_attention.py``).

The KV cache is a pool of fixed-size blocks ``(num_blocks, block_size,
h, d)``; each sequence owns a block table of physical block ids in
context order.  A decode step attends ONE query token per sequence to the
trailing ``window`` positions of its context (0 = all of it).  The kernel
(``csrc/paged_decode.cu``) replaces the Pallas kernel ``_paged_kernel``:
each block loads its own table entries, reads only the live positions and
runs an f32 online softmax in the log2 domain over q pre-scaled by
``sm_scale*log2(e)``.

``window=1`` is an exact gather of the stored row (softmax over one
position is exactly 1.0), in the kernel and in the plain version; the
serving decoder's bitwise chains rest on it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import NEG_INF, _prescale

_KERNEL = "paged_decode"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, block_tables,
                              context_lens, *,
                              sm_scale: Optional[float] = None,
                              window: int = 0) -> torch.Tensor:
    """Plain oracle: gather each sequence's context contiguously through
    its block table, then plain softmax attention in f32.  q: ``(B, h,
    d)``; caches ``(num_blocks, block_size, h, d)``; returns ``(B, h, d)``
    f32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qh, kc, vc = q.float(), k_cache.float(), v_cache.float()
    bt = torch.as_tensor(block_tables, device="cpu").tolist()
    cl = torch.as_tensor(context_lens, device="cpu").tolist()
    bs = kc.shape[1]
    out = torch.zeros_like(qh)
    for b in range(qh.shape[0]):
        n = int(cl[b])
        pages = torch.as_tensor(bt[b][: -(-n // bs)], device=kc.device)
        k = kc[pages].reshape(-1, *kc.shape[2:])[:n]    # (n, h, d)
        v = vc[pages].reshape(-1, *vc.shape[2:])[:n]
        lo = max(0, n - window) if window else 0
        k, v = k[lo:], v[lo:]
        s = torch.einsum("hd,khd->hk", qh[b], k) * sm_scale
        p = torch.softmax(s, dim=-1)
        out[b] = torch.einsum("hk,khd->hd", p, v)
    return out


def _paged_attention_plain(qs: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, bt: torch.Tensor,
                           cl: torch.Tensor, window: int) -> torch.Tensor:
    """Plain version of K4 on pre-scaled q: gather every table page,
    mask positions outside ``[max(ctx - window, 0), ctx)`` (their scores
    to NEG_INF, their values to 0, so padding pages never leak in), and
    softmax in the log2 domain in f32."""
    B, h, d = qs.shape
    bs = k_cache.shape[1]
    width = bt.shape[1] * bs
    k = k_cache[bt.long()].reshape(B, width, h, d).float()
    v = v_cache[bt.long()].reshape(B, width, h, d).float()
    pos = torch.arange(width, device=qs.device)[None, :]
    ctx = cl.long()[:, None]
    start = (ctx - window).clamp(min=0) if window else torch.zeros_like(ctx)
    live = (pos >= start) & (pos < ctx)                      # (B, width)
    s = torch.einsum("bhd,bkhd->bhk", qs.float(), k)
    s = torch.where(live[:, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    v = torch.where(live[:, :, None, None], v, torch.zeros_like(v))
    o = torch.einsum("bhk,bkhd->bhd", p, v) / l
    return o.to(qs.dtype)


def _paged_attention_cuda(qs: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, bt: torch.Tensor,
                          cl: torch.Tensor, window: int) -> torch.Tensor:
    """Launch K4 on the current stream."""
    dev = qs.device
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if qs.dtype not in _DTYPES or k_cache.dtype != qs.dtype \
            or v_cache.dtype != qs.dtype:
        raise TypeError(f"paged kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {qs.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}")
    if bt.dtype != torch.int32 or cl.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    B, h, d = qs.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[2:] != (h, d):
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(qs.shape)}")
    if bt.dim() != 2 or bt.shape[0] != B or cl.shape != (B,):
        raise ValueError(f"block_tables {tuple(bt.shape)} / context_lens "
                         f"{tuple(cl.shape)} do not fit batch {B}")
    if not (1 <= d <= 256):
        raise ValueError(f"paged kernel takes head_dim <= 256, got {d}")
    for name, x in (("q", qs), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", bt), ("context_lens", cl)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    o = torch.empty_like(qs)
    fn = _build.function(
        _KERNEL, "rtt_paged_decode",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(qs.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 bt.data_ptr(), cl.data_ptr(), o.data_ptr(),
                 _DTYPES[qs.dtype], B, h, d, k_cache.shape[1], bt.shape[1],
                 int(window), stream)
    _build.launches[_KERNEL] += 1
    _build.check_launch(_KERNEL, err)
    return o


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    sm_scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    q: ``(B, h, d)`` — one query token per sequence.
    k_cache/v_cache: ``(num_blocks, block_size, h, d)`` physical pool.
    block_tables: ``(B, max_pages)`` int32 — per-sequence physical block
    ids in context order; entries past ``ceil(context_len/block_size)``
    may be arbitrary valid indices (padding).
    context_lens: ``(B,)`` int32, each >= 1.
    window: attend only to the trailing ``window`` positions (0 = all).
    Returns ``(B, h, d)`` in q's dtype.

    CUDA tensors always launch the kernel K4 (float32 or bfloat16, head_dim
    <= 256, contiguous, int32 tables); what it does not take raises.  CPU
    tensors take the plain version.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    # Pre-scaled into the log2 domain and rounded back to q's dtype, as
    # the reference does.
    qs = _prescale(q, sm_scale)
    bt = torch.as_tensor(block_tables, device=q.device)
    cl = torch.as_tensor(context_lens, device=q.device)
    if q.is_cuda:
        return _paged_attention_cuda(qs, k_cache, v_cache, bt, cl, window)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return _paged_attention_plain(qs, k_cache, v_cache, bt, cl, window)
