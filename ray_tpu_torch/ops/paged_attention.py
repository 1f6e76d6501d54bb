"""Paged (block-table) decode attention: the hand-written CUDA kernel K4
and its plain PyTorch version (counterpart:
``ray_tpu/ops/paged_attention.py``).

The KV cache is a pool of fixed-size blocks ``(num_blocks, block_size,
h, d)``; each sequence owns a block table of physical block ids in
context order.  A decode step attends ONE query token per sequence to the
trailing ``window`` positions of its context (0 = all of it).  The kernel
(``csrc/paged_decode.cu``) replaces the Pallas kernel ``_paged_kernel``:
an f32 online softmax in the log2 domain over q pre-scaled by
``sm_scale*log2(e)`` (the kernel scales q itself), one warp per (split,
head, sequence), each split a run of whole live pages (``_split_plan``)
streamed through a shared-memory ring by bulk copies (``_ring_stages``),
and the splits merged by the last of them in the same launch.

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
_ARGS = (_P,) * 8 + (_I,) * 11 + (ctypes.c_float, _P)
_FN = None                  # the configured C launcher, at first launch
_BLOCKS_PER_SM = 8          # _split_plan's target of blocks per SM
_RING_BYTES = 26 * 1024     # a block's ring: 8 blocks fit an SM
_MAX_SMEM = 231424          # dynamic shared memory a block may ask for
_WORKSPACES: dict = {}      # (device index, stream) -> (partials, tickets)


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


def _split_plan(B: int, h: int, max_pages: int, bs: int, window: int,
                sm_count: int) -> Tuple[int, int]:
    """K4's split of each sequence's live pages over blocks, from shapes
    alone (no device sync): ``(nsplit, pages per split)``.

    The live range spans at most ``span`` pages: the whole table, or for a
    window of w positions ``ceil((w - 1) / bs) + 1`` pages.  Splits are
    added while ``B * h * nsplit`` blocks stay within eight per SM (what
    fits at once), each split a whole number of pages; ``window=1`` spans one page and gets 1 split.
    Split s of a sequence takes its live pages ``[first + s*pps, first +
    (s+1)*pps)``, where ``first`` is the page of its first live position.
    """
    span = max(1, max_pages)
    if window > 0:
        span = min(span, -(-(window - 1) // bs) + 1)
    nsplit = min(span, max(1, _BLOCKS_PER_SM * sm_count // (B * h)))
    pps = -(-span // nsplit)
    return -(-span // pps), pps


def _lanes_per_row(bs: int, d: int) -> int:
    """log2 of the lanes that share a row of a page in K4: at least 32 /
    bs (every lane has a row) and at least d / 64 (a lane holds at most 64
    f32 of q and 64 of its sum), a power of two <= 32."""
    need = max(-(-32 // bs), -(-d // 64))
    return min(5, (need - 1).bit_length())


def _ring_stages(bs: int, d: int, elem: int) -> int:
    """Ring slots of one page's k and v rows (``2 * bs`` rows of ``d *
    elem`` bytes, each padded by 16 B): as many as fit in ``_RING_BYTES``,
    at least 3 and at most 8.  Raises when 3 slots
    and the page's scores do not fit a block's shared memory."""
    row_bytes = d * elem
    stage = 2 * bs * (row_bytes + 16)
    if 3 * stage + 4 * bs > _MAX_SMEM:
        raise ValueError(
            f"paged kernel: a page of {bs} rows of {row_bytes} B (k and v) "
            f"needs {3 * stage + 4 * bs} B of shared memory for its 3-slot "
            f"ring, more than {_MAX_SMEM}; use a smaller block_size")
    return max(3, min(8, _RING_BYTES // stage))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _launch_plan(B: int, h: int, d: int, elem: int, bs: int, max_pages: int,
                 window: int, index: int) -> Tuple[int, int, int, int]:
    """(ring slots, nsplit, pages per split, log2 lanes per row) of a K4
    launch, once per shape: the serving path calls with the same few."""
    nsplit, pps = _split_plan(B, h, max_pages, bs, window, _sm_count(index))
    return _ring_stages(bs, d, elem), nsplit, pps, _lanes_per_row(bs, d)


def _workspace(dev: torch.device, stream: int, n_ws: int, n_tickets: int):
    """The (f32 partials, int32 tickets) of split launches on one stream,
    grown as needed.  The kernel leaves every ticket at 0, and launches on
    one stream run in order, so a stream's workspace is reused as it is."""
    key = (dev.index, stream)
    ws, tickets = _WORKSPACES.get(key, (None, None))
    if ws is None or ws.numel() < n_ws or tickets.numel() < n_tickets:
        ws = torch.empty(max(n_ws, 0 if ws is None else ws.numel()),
                         dtype=torch.float32, device=dev)
        tickets = torch.zeros(max(n_tickets, 0 if tickets is None
                                  else tickets.numel()),
                              dtype=torch.int32, device=dev)
        _WORKSPACES[key] = ws, tickets
    return ws, tickets


def _launcher():
    global _FN
    if _FN is None:
        _FN = _build.function(_KERNEL, "rtt_paged_decode", list(_ARGS))
    return _FN


def _paged_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, bt: torch.Tensor,
                          cl: torch.Tensor, window: int,
                          qscale: float) -> torch.Tensor:
    """Launch K4 on the current stream.  q is unscaled: the kernel forms
    ``q * qscale`` rounded to q's dtype (``qscale`` already rounded to it),
    bitwise ``_prescale``."""
    dev = q.device
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", bt), ("context_lens", cl)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    dtype = _DTYPES.get(q.dtype)
    if dtype is None or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"paged kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}")
    if bt.dtype != torch.int32 or cl.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
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
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", bt), ("context_lens", cl)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q_p, k_p, v_p = q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()
    if (q_p | k_p | v_p) % 16:
        raise ValueError("q, k_cache and v_cache must start on a 16-byte "
                         "boundary")
    bs, max_pages, window = k_cache.shape[1], bt.shape[1], int(window)
    stages, nsplit, pps, lpr_log2 = _launch_plan(
        B, h, d, q.element_size(), bs, max_pages, window, dev.index)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = tickets = None
    if nsplit > 1:
        ws, tickets = _workspace(dev, stream, B * h * nsplit * (d + 2), B * h)
        ws, tickets = ws.data_ptr(), tickets.data_ptr()
    args = (q_p, k_p, v_p, bt.data_ptr(), cl.data_ptr(), o.data_ptr(), ws,
            tickets, dtype, B, h, d, bs, max_pages, window, nsplit, pps,
            stages, lpr_log2, qscale, stream)
    fn = _launcher()
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
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
