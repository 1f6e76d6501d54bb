"""The train step's optimizer: the global norm of the grads and the
clipped AdamW update, as the hand-written CUDA kernels K5 and their plain
PyTorch versions (counterpart: optax's ``chain(clip_by_global_norm,
adamw)``, which the reference leaves to XLA; it has no kernel of its own).

CUDA leaves launch the kernels of ``csrc/optim.cu``: ``rtt_optim_sumsq``
sums the squares of every grad and writes the norm's square root on the
device, then ``rtt_optim_adamw`` reads p, g, m and v once and writes p, m
and v once, in place, clipping from the norm's pointer with no host sync:
32 bytes a parameter in all, one launch a pass for a tree whose pointer
table fits a launch's parameters (``plan`` splits a larger one into as few
launches as its tables need).  CPU leaves take the plain versions, the
port's optimizer as it was written before the kernels.  A CUDA leaf that
is not f32, or a param or moment that is not contiguous, raises (a grad
that is not contiguous is read as a contiguous copy); there is no
fallback from one to the other.

DTensor leaves: the norm is the plain version's, whose squares of a
sharded leaf are summed over its shards; the update takes each rank's
local shards (the caller passes them), through the kernel on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.ops import _build

_KERNEL = "optim"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SUMSQ_ARGS = (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_ADAMW_ARGS = (_I,) + (_P,) * 7 + (_F,) * 10 + (_I, _P)
_WORKSPACES: dict = {}      # (device, stream) -> (f64 partials, counter)


class Limits(NamedTuple):
    """csrc/optim.cu's constants: the elements a block reads at once and
    the leaves a launch's pointer table holds, for each kernel, and the
    blocks an SM runs."""
    sumsq_chunk: int
    adamw_chunk: int
    sumsq_leaves: int
    adamw_leaves: int
    blocks_per_sm: int


@functools.lru_cache(maxsize=None)
def limits() -> Limits:
    out = (ctypes.c_int * len(Limits._fields))()
    _build.function(_KERNEL, "rtt_optim_limits", [_P])(out)
    return Limits(*out)


class Launch(NamedTuple):
    """One launch's pointer table: the indices of its leaves in the tree
    (empty leaves left out) and each one's first chunk, then the end."""
    leaves: tuple
    chunk0: tuple


def plan(numels: Sequence[int], chunk: int, most: int) -> List[Launch]:
    """The launches over leaves of ``numels`` elements, in order: up to
    ``most`` leaves each, every non-empty leaf in one launch, cut into
    chunks of ``chunk`` elements."""
    out, leaves, chunk0 = [], [], [0]
    for i, n in enumerate(numels):
        if not n:
            continue
        if len(leaves) == most:
            out.append(Launch(tuple(leaves), tuple(chunk0)))
            leaves, chunk0 = [], [0]
        leaves.append(i)
        chunk0.append(chunk0[-1] + -(-n // chunk))
    if leaves:
        out.append(Launch(tuple(leaves), tuple(chunk0)))
    return out


def _global_norm_plain(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    sq = [g.float().square().sum() for g in leaves]
    return torch.sqrt(sum(x.full_tensor() if isinstance(x, DTensor) else x
                          for x in sq))


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all leaves together, a 0-d f32.
    The squares of a sharded leaf are summed over its shards.  CUDA leaves
    (no DTensor among them) take ``rtt_optim_sumsq``: one launch, the
    partials summed in a fixed order, so two calls give the same bits."""
    leaves = list(leaves)
    if not leaves or not leaves[0].is_cuda or any(
            isinstance(g, DTensor) for g in leaves):
        return _global_norm_plain(leaves)
    return _sumsq_cuda(leaves)


def _adamw_plain_(ps, gs, ms, vs, grad_norm, *, grad_clip, b1, b2, eps,
                  weight_decay, lr, bc1, bc2) -> None:
    if grad_clip is not None:
        keep = grad_norm < grad_clip
        gs = [torch.where(keep, g, g / grad_norm * grad_clip) for g in gs]
    for p, g, m, v in zip(ps, gs, ms, vs):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        upd = (m / bc1) / ((v / bc2).sqrt() + eps)
        if weight_decay:
            upd.add_(p, alpha=weight_decay)
        p.add_(upd, alpha=-lr)


@torch.no_grad()
def adamw_(ps: List[torch.Tensor], gs: List[torch.Tensor],
           ms: List[torch.Tensor], vs: List[torch.Tensor], grad_norm, *,
           grad_clip: Optional[float], b1: float, b2: float, eps: float,
           weight_decay: float, lr: float, bc1: float, bc2: float) -> None:
    """One clipped AdamW step on the params ``ps`` and moments ``ms``,
    ``vs`` in place, from the grads ``gs`` (plain tensors, one list each,
    in one order) and ``grad_norm``, their global norm: grads scaled by
    ``grad_clip / grad_norm`` when ``grad_norm >= grad_clip`` (no clip
    with ``grad_clip=None``), then ``m = b1 m + (1 - b1) g``, ``v = b2 v +
    (1 - b2) g^2``, ``p -= lr ((m / bc1) / (sqrt(v / bc2) + eps) +
    weight_decay p)``.  CUDA leaves take ``rtt_optim_adamw``; CPU leaves
    the plain version."""
    cuda = {p.is_cuda for p in ps}
    if len(cuda) > 1:
        raise ValueError("AdamW: the params are on CPU and CUDA devices")
    args = dict(grad_clip=grad_clip, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay, lr=lr, bc1=bc1, bc2=bc2)
    if cuda == {True}:
        _adamw_cuda_(ps, gs, ms, vs, grad_norm, **args)
    else:
        _adamw_plain_(ps, gs, ms, vs, grad_norm, **args)


def _check(what: str, ts: Sequence[torch.Tensor], dev: torch.device) -> None:
    for i, t in enumerate(ts):
        _build.check_operand(_KERNEL, f"{what}[{i}]", t, dev, torch.float32)


def _ptrs(ts: Sequence[torch.Tensor], launch: Launch):
    return (ctypes.c_uint64 * len(launch.leaves))(
        *(ts[i].data_ptr() for i in launch.leaves))


def _table(ts: Sequence[torch.Tensor], launch: Launch):
    numel = (ctypes.c_longlong * len(launch.leaves))(
        *(ts[i].numel() for i in launch.leaves))
    return numel, (ctypes.c_longlong * len(launch.chunk0))(*launch.chunk0)


def _workspace(dev: torch.device, stream: int, n_partials: int):
    """The f64 partials and the int32 ticket counter of norm launches on
    one stream.  The kernel leaves the counter at 0, and launches on one
    stream run in order, so a stream's workspace is reused as it is."""
    key = (dev.index, stream)
    bufs = _WORKSPACES.get(key)
    if bufs is None or bufs[0].numel() < n_partials:
        counter = bufs[1] if bufs else torch.zeros(1, dtype=torch.int32,
                                                   device=dev)
        bufs = (torch.empty(n_partials, dtype=torch.float64, device=dev),
                counter)
        _WORKSPACES[key] = bufs
    return bufs


def _dense(gs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The grads, each contiguous: autograd hands back a leaf that enters
    the loss only through ``sum()`` as an expanded view (stride 0), which
    the kernels read as the dense tensor it stands for."""
    return [g if g.is_contiguous() else g.contiguous() for g in gs]


def _sumsq_cuda(gs: List[torch.Tensor]) -> torch.Tensor:
    dev = gs[0].device
    gs = _dense(gs)
    _check("grads", gs, dev)
    lim = limits()
    launches = plan([g.numel() for g in gs], lim.sumsq_chunk,
                    lim.sumsq_leaves)
    if not launches:
        return torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    most = _build.sm_count(dev.index) * lim.blocks_per_sm
    grids = [min(most, lo.chunk0[-1]) for lo in launches]
    stream = _build.current_stream(dev)
    partials, counter = _workspace(dev, stream, sum(grids))
    base = 0
    for k, (lo, grid) in enumerate(zip(launches, grids)):
        numel, chunk0 = _table(gs, lo)
        _build.launch(
            _KERNEL, "rtt_optim_sumsq", _SUMSQ_ARGS, dev, len(lo.leaves),
            _ptrs(gs, lo), numel, chunk0, partials.data_ptr(),
            counter.data_ptr(), out.data_ptr(), base, sum(grids),
            int(k == len(launches) - 1), grid, stream=stream)
        base += grid
    return out


def _adamw_cuda_(ps, gs, ms, vs, grad_norm, *, grad_clip, b1, b2, eps,
                 weight_decay, lr, bc1, bc2) -> None:
    dev = ps[0].device
    gs = _dense(gs)
    for what, ts in (("params", ps), ("grads", gs), ("mu", ms), ("nu", vs)):
        _check(what, ts, dev)
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"leaf {i}: param {tuple(p.shape)}, grad "
                             f"{tuple(g.shape)}, moments {tuple(m.shape)} "
                             f"and {tuple(v.shape)} differ")
    norm = None
    if grad_clip is not None:
        if not (isinstance(grad_norm, torch.Tensor) and grad_norm.device == dev
                and grad_norm.dtype == torch.float32
                and grad_norm.numel() == 1):
            grad_norm = torch.as_tensor(grad_norm, dtype=torch.float32,
                                        device=dev)
        norm = grad_norm.data_ptr()
    lim = limits()
    most = _build.sm_count(dev.index) * lim.blocks_per_sm
    for lo in plan([p.numel() for p in ps], lim.adamw_chunk,
                   lim.adamw_leaves):
        numel, chunk0 = _table(ps, lo)
        _build.launch(
            _KERNEL, "rtt_optim_adamw", _ADAMW_ARGS, dev, len(lo.leaves),
            _ptrs(ps, lo), _ptrs(gs, lo), _ptrs(ms, lo), _ptrs(vs, lo),
            numel, chunk0, norm, 0.0 if grad_clip is None else grad_clip,
            b1, 1.0 - b1, b2, 1.0 - b2, bc1, bc2, eps, weight_decay, lr,
            min(most, lo.chunk0[-1]))
