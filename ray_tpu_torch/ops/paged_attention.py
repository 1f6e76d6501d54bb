"""Paged (block-table) decode attention: the hand-written CUDA kernel K4
and its plain PyTorch version (counterpart:
``ray_tpu/ops/paged_attention.py``).

The KV cache is a pool of fixed-size blocks ``(num_blocks, block_size,
h, d)``; each sequence owns a block table of physical block ids in
context order.  A decode step attends ONE query token per sequence to the
trailing ``window`` positions of its context (0 = all of it).  The kernel
(``csrc/paged_decode.cu``) replaces the Pallas kernel ``_paged_kernel``:
an f32 online softmax in the log2 domain over q pre-scaled by
``sm_scale*log2(e)`` (the kernel scales q itself), each weight rounded to
v's dtype before P.V as the reference rounds it, one warp per (split,
head, sequence), each split a run of whole live pages (``_split_plan``)
streamed through a shared-memory ring by bulk copies (``_ring_stages``),
every split starting from the running max of the pages before it, and the
splits merged by the last of them in the same launch.

``window=1`` is an exact gather of the stored row (softmax over one
position is exactly 1.0), in the kernel and in the plain version; the
serving decoder's bitwise chains rest on it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import NEG_INF, _prescale, _prescale_const

_KERNEL = "paged_decode"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 9 + (_I,) * 11 + (ctypes.c_float, _I, _P)
_BLOCKS_PER_SM = 8          # _split_plan's target of blocks per SM
_RING_BYTES = 26 * 1024     # a block's ring of page slots
_SCORE_BYTES = 16 * 1024    # a split's scores, kept between its two passes
_MAX_SMEM = 231424          # dynamic shared memory a block may ask for
_WORKSPACES: dict = {}      # (device, stream) -> (partials, tickets, flags)
_EPOCH = [0]                # the last split launch's flag value


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
    """Plain version of K4 on pre-scaled q, page by page as the reference
    kernel walks them: an f32 online softmax in the log2 domain whose l
    sums the f32 p and whose accumulator takes p rounded to v's dtype.
    Positions outside ``[max(ctx - window, 0), ctx)`` have their scores
    set to NEG_INF and their values to 0, and a page holding none of them
    leaves the state as it was, so padding pages never leak in."""
    B, h, d = qs.shape
    bs = k_cache.shape[1]
    dev = qs.device
    q = qs.float()
    ctx = cl.long()[:, None, None]                           # (B, 1, 1)
    start = (ctx - window).clamp(min=0) if window else torch.zeros_like(ctx)
    m = torch.full((B, h, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, h, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, h, d), dtype=torch.float32, device=dev)
    for i in range(bt.shape[1]):
        page = bt[:, i].long()
        pos = i * bs + torch.arange(bs, device=dev)[None, None, :]
        rows = (pos >= start) & (pos < ctx)                  # (B, 1, bs)
        live = rows.any(dim=-1, keepdim=True)                # (B, 1, 1)
        s = torch.einsum("bhd,bkhd->bhk", q, k_cache[page].float())
        s = torch.where(rows, s, torch.full_like(s, NEG_INF))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        p = torch.exp2(s - m_next)                           # (B, h, bs)
        v = v_cache[page]
        v = torch.where(rows[:, 0, :, None, None], v, torch.zeros_like(v))
        pv = torch.einsum("bhk,bkhd->bhd", p.to(v.dtype).float(), v.float())
        m = torch.where(live, m_next, m)
        l = torch.where(live, l * alpha + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(live, acc * alpha + pv, acc)
    return (acc / l).to(qs.dtype)


def _split_plan(B: int, h: int, max_pages: int, bs: int, window: int,
                sm_count: int) -> Tuple[int, int]:
    """K4's split of each sequence's live pages over blocks, from shapes
    alone (no device sync): ``(nsplit, pages per split)``.

    The live range spans at most ``span`` pages: the whole table, or for a
    window of w positions ``ceil((w - 1) / bs) + 1`` pages.  Splits are
    added while ``B * h * nsplit`` blocks stay within eight per SM, each
    split a whole number of pages; ``window=1`` spans one page and gets 1
    split.  Several splits keep their scores in shared memory between
    their two passes, so a split then holds at most ``_SCORE_BYTES`` of
    them (4 bytes a position and a page's max), which may add splits.
    Split s of a sequence takes its live pages ``[first + s*pps, first +
    (s+1)*pps)``, where ``first`` is the page of its first live position.
    """
    span = max(1, max_pages)
    if window > 0:
        span = min(span, -(-(window - 1) // bs) + 1)
    nsplit = min(span, max(1, _BLOCKS_PER_SM * sm_count // (B * h)))
    pps = -(-span // nsplit)
    if nsplit > 1:
        pps = min(pps, max(1, _SCORE_BYTES // (4 * (bs + 1))))
    return -(-span // pps), pps


def _lanes_per_row(bs: int, d: int) -> int:
    """log2 of the lanes that share a row of a page in K4: at least 32 /
    bs (every lane has a row) and at least d / 64 (a lane holds at most 64
    f32 of q and 64 of its sum), a power of two <= 32."""
    need = max(-(-32 // bs), -(-d // 64))
    return min(5, (need - 1).bit_length())


def _ring_stages(bs: int, d: int, elem: int) -> int:
    """Ring slots of one page's k or v rows (``bs`` rows of ``d * elem``
    bytes, each padded by 16 B): as many as fit in ``_RING_BYTES``, at
    least 3 and at most 8.  Raises when 3 slots and a page's scores do not
    fit a block's shared memory."""
    row_bytes = d * elem
    stage = bs * (row_bytes + 16)
    if 3 * stage + 4 * (bs + 1) > _MAX_SMEM:
        raise ValueError(
            f"paged kernel: a page of {bs} rows of {row_bytes} B needs "
            f"{3 * stage + 4 * (bs + 1)} B of shared memory for its 3-slot "
            f"ring and its scores, more than {_MAX_SMEM}; use a smaller "
            f"block_size")
    return max(3, min(8, _RING_BYTES // stage))


@functools.lru_cache(maxsize=1024)
def _launch_plan(B: int, h: int, d: int, elem: int, bs: int, max_pages: int,
                 window: int, index: int) -> Tuple[int, int, int, int]:
    """(ring slots, nsplit, pages per split, log2 lanes per row) of a K4
    launch, once per shape: the serving path calls with the same few."""
    nsplit, pps = _split_plan(B, h, max_pages, bs, window, _build.sm_count(index))
    return _ring_stages(bs, d, elem), nsplit, pps, _lanes_per_row(bs, d)


def _workspace(dev: torch.device, stream: int, n_ws: int, n_tickets: int,
               n_flags: int):
    """The (f32 partials, int32 tickets, int32 flags) of split launches on
    one stream, grown as needed.  The kernel leaves every ticket at 0 and
    sets flags only to its launch's epoch, and launches on one stream run
    in order, so a stream's workspace is reused as it is."""
    key = (dev.index, stream)
    bufs = _WORKSPACES.get(key)
    if bufs is None or bufs[0].numel() < n_ws or bufs[1].numel() < n_tickets \
            or bufs[2].numel() < n_flags:
        old = bufs or [torch.empty(0)] * 3
        bufs = (torch.empty(max(n_ws, old[0].numel()), dtype=torch.float32,
                            device=dev),
                torch.zeros(max(n_tickets, old[1].numel()),
                            dtype=torch.int32, device=dev),
                torch.zeros(max(n_flags, old[2].numel()), dtype=torch.int32,
                            device=dev))
        _WORKSPACES[key] = bufs
    return bufs


def _paged_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, bt: torch.Tensor,
                          cl: torch.Tensor, window: int,
                          qscale: float) -> torch.Tensor:
    """Launch K4 on the current stream.  q is unscaled: the kernel forms
    ``q * qscale`` rounded to q's dtype (``qscale`` already rounded to it),
    bitwise ``_prescale``."""
    dev = q.device
    dtype = _DTYPES.get(q.dtype)
    if dtype is None:
        raise TypeError(f"paged kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}")
    check = _build.check_operand
    q_p = check(_KERNEL, "q", q, dev, q.dtype, aligned=True)
    k_p = check(_KERNEL, "k_cache", k_cache, dev, q.dtype, aligned=True)
    v_p = check(_KERNEL, "v_cache", v_cache, dev, q.dtype, aligned=True)
    bt_p = check(_KERNEL, "block_tables", bt, dev, torch.int32)
    cl_p = check(_KERNEL, "context_lens", cl, dev, torch.int32)
    B, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[2:] != (h, d):
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if bt.dim() != 2 or bt.shape[0] != B or cl.shape != (B,):
        raise ValueError(f"block_tables {tuple(bt.shape)} / context_lens "
                         f"{tuple(cl.shape)} do not fit batch {B}")
    row_bytes = d * q.element_size()
    if not (1 <= d <= 256) or row_bytes % 16:
        raise ValueError(f"paged kernel takes head_dim <= 256 whose rows are "
                         f"a multiple of 16 bytes (of 8 bf16 or 4 f32 "
                         f"values), got {d} x {q.dtype}")
    bs, max_pages, window = k_cache.shape[1], bt.shape[1], int(window)
    stages, nsplit, pps, lpr_log2 = _launch_plan(
        B, h, d, q.element_size(), bs, max_pages, window, dev.index)
    o = torch.empty_like(q)
    stream = _build.current_stream(dev)
    ws = tickets = flags = None
    epoch = 0
    if nsplit > 1:
        # Partials (acc, m, l) and published maxima; merge tickets and
        # split counters; flags.  Each split launch sets its flags to a new
        # epoch, so the flags never need a reset.
        ws, tickets, flags = (x.data_ptr() for x in _workspace(
            dev, stream, B * h * nsplit * (d + 3), 2 * B * h, B * h * nsplit))
        _EPOCH[0] = _EPOCH[0] % 0x7FFFFFFE + 1
        epoch = _EPOCH[0]
    _build.launch(_KERNEL, "rtt_paged_decode", _ARGS, dev, q_p, k_p, v_p,
                  bt_p, cl_p, o.data_ptr(), ws, tickets, flags, dtype, B, h,
                  d, bs, max_pages, window, nsplit, pps, stages, lpr_log2,
                  qscale, epoch, stream=stream)
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
    <= 256 with rows a multiple of 16 bytes, q and caches contiguous and
    16-byte aligned, int32 tables, a block_size whose 3-slot ring fits
    shared memory); what it does not take raises.  CPU tensors take the
    plain version.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    bt, cl = block_tables, context_lens
    if not isinstance(bt, torch.Tensor) or bt.device != q.device:
        bt = torch.as_tensor(bt, device=q.device)
    if not isinstance(cl, torch.Tensor) or cl.device != q.device:
        cl = torch.as_tensor(cl, device=q.device)
    if q.is_cuda:
        # The kernel pre-scales q itself (as _prescale does).
        return _paged_attention_cuda(q, k_cache, v_cache, bt, cl, window,
                                     _prescale_const(sm_scale, q.dtype))
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    # Pre-scaled into the log2 domain and rounded back to q's dtype, as
    # the reference does.
    return _paged_attention_plain(_prescale(q, sm_scale), k_cache, v_cache,
                                  bt, cl, window)
