"""Distributed pipeline-parallel training: 1F1B stage actors over the
object plane (counterpart: ``ray_tpu/train/pipeline_actors.py``).

Reference: PipeDream (SOSP'19) one-forward-one-backward scheduling and
GPipe (NeurIPS'19) micro-batching.  ``parallel/pipeline.py`` runs the
GPipe schedule inside one process group; this module takes the step
across PROCESSES: each stage is a long-lived restartable actor owning its
stage's params, and the 1F1B schedule is driven by the actor call
pipeline itself.

- **Data plane**: micro-batch activations (forward) and activation
  gradients (backward) cross stage to stage as numpy segment images
  pushed over the direct-put verbs (``ObjectPusher.push``), never as
  pickled tensors (which would ride in-band).  A bf16 tensor crosses as
  its int16 bit pattern with a tag (numpy has no bfloat16) and is viewed
  back on arrival.  Only a tiny descriptor
  ``("__mbdescr__", kind, ident, total, home_store)`` rides the actor
  call's result.  A push to one's own store short-circuits through
  ``shm_store.put_local``, and a failed or stalled push HEDGES into the
  pusher's store (the consumer then pulls over the data plane).
- **Schedule**: the driver submits each stage's 1F1B call sequence
  (warmup ``min(pp-1-s, M)`` forwards, steady-state one-forward-one-
  backward, cooldown backwards) without blocking; per-actor FIFO
  execution realizes it and at most ``pp`` stashes are live per stage.
- **Backward**: recompute + ``torch.autograd.grad`` from the stashed
  INPUT (the reference's ``jax.vjp``): the input is detached and needs a
  grad only when it is floating point (stage 0's tokens get none), the
  stage function re-runs under grad, and the last stage differentiates
  ``loss_fn(stage_fn(p, x), target)``, deferred from its forward.
- **Fault story**: stages are ``max_restarts``/``max_task_retries``
  actors with ``__ray_save__``/``__ray_restore__`` hooks (params,
  optimizer state, accumulators and the stash, all as numpy); params
  change only inside ``apply_grads``, which is idempotent per step, so
  the driver re-drives a whole failed loss step (bounded by
  ``max_redrives``) and stages that already applied skip.
- **Device**: ``PipelineTrainer(..., device=None)`` means the card.  The
  single-host path runs the stages in the driver on that device; the
  actor path gives each stage one granted card (``num_tpus=1``) and
  raises if the runtime has fewer cards than stages.  ``device="cpu"``
  runs the stages on the CPU (the actor path then creates ``num_cpus``
  stages that hold no card, as the reference's stage workers do).
- **Fallback**: ``config.distributed_training`` off (or one stage, or no
  runtime) runs the single-host path: the same per-micro-batch
  loss/grad accumulation, in microbatch order, in this process, every
  counter below zero.

Numerics contract: the loss is the mean over micro-batches of
``loss_fn(stage_fn(...stage_fn(x_mb)), target_mb)`` and the gradients
the matching mean of per-micro-batch gradients (accumulated ``accum +
g`` in microbatch order, then divided by M) — so integer-valued float32
training matches the reference's ``pipeline_apply`` BITWISE.

LOCK ORDER: ``_STATS_LOCK`` is an independent LEAF — it guards only the
process-local counter dict read by ``train_stats()`` (the xfer_stats
flusher / ``transfer_stats()`` merge); no other lock is ever acquired
while holding it and it is never held across serialization, a push, or
any wire call.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

import ray_tpu_torch as ray
from ray_tpu_torch.remote_function import _bulk_submit
from ray_tpu_torch.train.trees import tree_leaves, tree_map, tree_unflatten

# ------------------------------------------------------------- counters --
# Process-local cumulative counters.  In workers (stage actors, remote
# learners) their ("xfer_stats", delta) rides ahead of each task's result
# and the periodic flush (worker_main looks this module up lazily); in the
# driver/head process transfer_stats() merges them directly.  All zero
# while distributed_training is off.
_STATS_LOCK = threading.Lock()  # lock-order: leaf (see module docstring)
_STATS = {
    "microbatch_pushes": 0,
    "stage_restarts": 0,
    "learner_queue_stalls": 0,
}


def note(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def train_stats() -> Dict[str, int]:
    """Cumulative snapshot (monotonic — the flusher ships deltas).  Not
    named ``stats()``: protocheck's counter-survival rule scans worker
    modules' ``stats()`` providers, and these keys are aggregated through
    the lazy flush hook instead."""
    with _STATS_LOCK:
        return dict(_STATS)


class _Bf16Bits:
    """A bfloat16 array on the wire: its int16 bit pattern."""
    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    def __reduce__(self):
        return (_Bf16Bits, (self.bits,))


def to_numpy_tree(tree: Any) -> Any:
    """Tensors -> numpy (CPU copies; bf16 as tagged int16 bits); other
    leaves (numpy arrays, counts) as they are.  What crosses the object
    plane, and what checkpoints and ``get_weights`` hand out."""
    import torch

    def conv(v):
        if not isinstance(v, torch.Tensor):
            return v
        v = v.detach().to("cpu", copy=True)   # never a view of live params
        if v.dtype == torch.bfloat16:
            return _Bf16Bits(v.view(torch.int16).numpy())
        return v.numpy()

    return tree_map(conv, tree)


def to_device_tree(tree: Any, device) -> Any:
    """``to_numpy_tree``'s inverse: numpy (and tensor) leaves -> tensors
    of their dtype on ``device``; other leaves as they are."""
    import torch

    def conv(v):
        if isinstance(v, _Bf16Bits):
            return torch.from_numpy(np.array(v.bits)).view(
                torch.bfloat16).to(device)
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.array(v)).to(device)
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return v

    return tree_map(conv, tree)


# ----------------------------------------------------------- data plane --
_DESCR_TAG = "__mbdescr__"


def _is_descr(v) -> bool:
    return isinstance(v, tuple) and len(v) == 5 and v[0] == _DESCR_TAG


def active_config():
    """The effective config: the runtime's (carries ``_system_config``
    overrides) when one is up, else the env-derived global."""
    from ray_tpu_torch._private import api_internal
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    rt = api_internal.get_runtime()
    return getattr(rt, "config", None) or GLOBAL_CONFIG


def _push_value(value, store: str) -> tuple:
    """Serialize one micro-batch value (numpy leaves) and land its
    segment image in ``store``: local short-circuit through
    ``put_local``, else a striped ``ObjectPusher.push``.  A failed,
    stalled or unsupported remote push HEDGES into the pusher's own store
    (the consumer pulls it over the data plane).  Returns ``(TAG, kind,
    ident, total, home_store)``."""
    from ray_tpu_torch._private import (
        api_internal, object_transfer, serialization)
    from ray_tpu_torch._private import shm_store as shm_mod
    from ray_tpu_torch._private.ids import ObjectID

    rt = api_internal.require_runtime()
    res = serialization.dumps_adaptive(value, 0)  # max_inline=0: parts
    meta, bufs = res[1], res[2]
    oid_bin = ObjectID.for_put().binary()
    if store and store != rt.store_id:
        ent = rt.resolve_store_addr(store)
        if ent is not None and object_transfer.peer_accepts_puts(ent[1]):
            try:
                kind, ident, total = rt._pusher.push(
                    store, ent[0], oid_bin, meta, bufs, caps=ent[1])
                note("microbatch_pushes")
                return (_DESCR_TAG, kind, ident, total, store)
            except Exception:
                # Dead or stalled-past-deadline link (the pusher already
                # retried with backoff): fall through to the local hedge.
                rt.forget_store_addr(store)
    kind, ident, total = shm_mod.put_local(rt.shm, oid_bin, meta, bufs)
    note("microbatch_pushes")
    return (_DESCR_TAG, kind, ident, total, rt.store_id)


def _load_value(descr: tuple):
    """Descriptor -> value.  Locally homed segments attach by name/path,
    deserialize, COPY (loaded arrays may be zero-copy views into the
    mapping) and unlink; hedged remote-homed ones pull over the data
    plane.  A segment already consumed (a replay re-reading its input)
    raises — the driver's step re-drive is the recovery path."""
    import os

    from ray_tpu_torch._private import api_internal, protocol

    _tag, kind, ident, total, store = descr
    rt = api_internal.require_runtime()
    if store == rt.store_id:
        if kind == "spilled":
            seg = rt.shm.attach_path(ident)
            try:
                value = _copy_arrays(seg.deserialize())
            finally:
                seg.close()
            try:
                os.unlink(ident)
            except OSError:
                pass
        else:
            seg = rt.shm.attach(ident)
            try:
                value = _copy_arrays(seg.deserialize())
            finally:
                seg.close()
            # Owner-routed free: releases the node byte accounting the
            # pusher's reserve_put charged.
            rt.shm.unlink(ident, total)
        return value
    pkind = protocol.SHM if kind == "shm" else protocol.SPILLED
    return rt.materialize((pkind, ident, total, store))


def _copy_arrays(tree):
    def copy(v):
        if isinstance(v, np.ndarray):
            return np.array(v, copy=True)
        if isinstance(v, _Bf16Bits):
            return _Bf16Bits(np.array(v.bits, copy=True))
        return v

    return tree_map(copy, tree)


def _split_microbatches(x, num_microbatches: int) -> List[Any]:
    """Split every leaf (tensor or array) along axis 0 into
    ``num_microbatches`` equal pieces (the GPipe micro-batching
    contract); a batch that does not divide raises."""
    for v in tree_leaves(x):
        if v.shape[0] % num_microbatches:
            raise ValueError(
                f"batch {v.shape[0]} % microbatches {num_microbatches}"
                " != 0")

    def piece(i):
        return tree_map(
            lambda v: v[i * (v.shape[0] // num_microbatches):
                        (i + 1) * (v.shape[0] // num_microbatches)], x)

    return [piece(i) for i in range(num_microbatches)]


def _stage_grads(stage_fn: Callable, loss_fn: Optional[Callable], params,
                 x, g=None, target=None, need_gx: bool = True):
    """Recompute the stage's forward from its input under grad and
    differentiate it: ``(loss or None, param grads (params' tree), input
    grad or None)``.  With ``loss_fn`` the output is ``loss_fn(y,
    target)`` (the last stage), else ``y`` is pulled back with
    cotangent ``g``.  The input gets a grad only if it is floating point
    and ``need_gx``."""
    import torch

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    x = x.detach()
    want_x = need_gx and x.is_floating_point()
    if want_x:
        x.requires_grad_()
    with torch.enable_grad():
        y = stage_fn(live, x)
        if loss_fn is not None:
            y, g = loss_fn(y, target), None
        grads = torch.autograd.grad(
            y, leaves + ([x] if want_x else []), g)
    loss = None if loss_fn is None else y.detach()
    gp = tree_unflatten(params, grads[:len(leaves)])
    return loss, gp, (grads[-1] if want_x else None)


# ------------------------------------------------------------ the actor --
@ray.remote
class PipelineStage:
    """One pipeline stage: owns its stage's params (and optimizer
    state), computes micro-batch forwards and backwards, pushes
    activations downstream and activation grads upstream over the put
    path.

    Single-threaded by the actor model; FIFO call order from the driver
    IS the stage's 1F1B schedule.  Backward recomputes the forward from
    the stashed INPUT, so the stash is plain tensors, checkpointable and
    bounded at ``pp`` entries in steady state."""

    def __init__(self, stage_fn: Callable, loss_fn: Optional[Callable],
                 params, optimizer, stage_idx: int, num_stages: int,
                 num_microbatches: int, device: str):
        from ray_tpu_torch._private.device import resolve_device

        self._dev = resolve_device(None if device == "cuda" else device)
        self._stage_fn = stage_fn
        self._loss_fn = loss_fn
        self._idx = stage_idx
        self._pp = num_stages
        self._M = num_microbatches
        self._params = to_device_tree(params, self._dev)
        self._optimizer = optimizer
        self._opt_state = optimizer.init(self._params)
        self._applied_step = -1
        self._last_metrics: Dict[str, float] = {}
        self._next_store = ""
        self._prev_store = ""
        self._stash: Dict[int, Any] = {}
        self._accum = None
        self._loss_sum = 0.0
        self._busy_s = 0.0

    # -- wiring ----------------------------------------------------------
    def get_store(self) -> str:
        from ray_tpu_torch._private import api_internal

        return api_internal.require_runtime().store_id

    def set_links(self, next_store: str, prev_store: str) -> bool:
        self._next_store = next_store
        self._prev_store = prev_store
        return True

    def ping(self) -> bool:
        return True

    def pid(self) -> int:
        import os

        return os.getpid()

    def _sync(self):
        import torch

        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)

    # -- schedule body ----------------------------------------------------
    def forward(self, mb: int, x, target=None):
        """This stage's forward for micro-batch ``mb``.  ``x`` is the raw
        micro-batch on stage 0 (driver-supplied numpy) or the upstream
        stage's push descriptor; the LAST stage also receives its
        ``target`` and returns None (its backward seeds from the loss),
        every other stage pushes its activation into the successor's
        store and returns the descriptor."""
        import torch

        if _is_descr(x):
            x = _load_value(x)
        x = to_device_tree(x, self._dev)
        t0 = time.perf_counter()
        if self._idx == self._pp - 1:
            # Loss stage: the compute is deferred to backward, which
            # recomputes the forward — stash input and target.
            self._stash[mb] = (x, to_device_tree(target, self._dev))
            self._busy_s += time.perf_counter() - t0
            return None
        with torch.no_grad():
            y = self._stage_fn(self._params, x)
        self._sync()
        self._busy_s += time.perf_counter() - t0
        self._stash[mb] = (x, None)
        return _push_value(to_numpy_tree(y), self._next_store)

    def backward(self, mb: int, g=None):
        """This stage's backward for micro-batch ``mb``: recompute the
        forward from the stashed input, accumulate the param gradient,
        push the input gradient upstream (stages > 0) and return its
        descriptor."""
        if mb not in self._stash:
            raise RuntimeError(
                f"stage {self._idx}: no stashed activation for "
                f"microbatch {mb} (replayed past a consumed input)")
        x, target = self._stash.pop(mb)
        last = self._idx == self._pp - 1
        if not last:
            if _is_descr(g):
                g = _load_value(g)
            g = to_device_tree(g, self._dev)
        t0 = time.perf_counter()
        loss, gp, gx = _stage_grads(
            self._stage_fn, self._loss_fn if last else None, self._params,
            x, g=g, target=target, need_gx=self._idx > 0)
        self._sync()
        self._busy_s += time.perf_counter() - t0
        if last:
            self._loss_sum += float(loss)
        self._accum = gp if self._accum is None else tree_unflatten(
            gp, [a + b for a, b in zip(tree_leaves(self._accum),
                                       tree_leaves(gp))])
        if self._idx == 0:
            return None
        return _push_value(to_numpy_tree(gx), self._prev_store)

    def apply_grads(self, step: int) -> Dict[str, float]:
        """Optimizer step over the accumulated gradients / M.  IDEMPOTENT
        per ``step``: a re-driven loss step skips stages that already
        applied and returns their cached metrics — params advance exactly
        once."""
        from ray_tpu_torch.train.core import global_norm

        if self._applied_step >= step:
            return dict(self._last_metrics)
        if self._accum is None:
            raise RuntimeError(
                f"stage {self._idx}: apply_grads({step}) with no "
                "accumulated gradients")
        grads = tree_map(lambda a: a / self._M, self._accum)
        norm = global_norm(tree_leaves(grads))
        self._optimizer.update_(grads, self._opt_state, self._params, norm)
        self._sync()
        self._applied_step = step
        metrics = {"step": float(step), "grad_norm": float(norm)}
        if self._idx == self._pp - 1:
            metrics["loss"] = self._loss_sum / self._M
        self._accum = None
        self._stash.clear()
        self._loss_sum = 0.0
        self._last_metrics = metrics
        return dict(metrics)

    def reset_step(self, step: int) -> bool:
        """Clear partial state for a re-drive of ``step``.  A stage that
        already applied ``step`` keeps its post-step params (its
        apply_grads will no-op); every other stage drops its stash and
        accumulators so the re-driven schedule starts clean."""
        if self._applied_step < step:
            self._stash.clear()
            self._accum = None
            self._loss_sum = 0.0
        return True

    # -- introspection ----------------------------------------------------
    def get_params(self):
        return to_numpy_tree(self._params)

    def get_grad_accum(self):
        """Test hook: the raw (unscaled) gradient accumulator."""
        return None if self._accum is None else to_numpy_tree(self._accum)

    def stage_stats(self) -> Dict[str, float]:
        return {"busy_s": self._busy_s, "applied_step": self._applied_step,
                "stash": len(self._stash)}

    # -- checkpoint hooks -------------------------------------------------
    def __ray_save__(self):
        return {
            "params": to_numpy_tree(self._params),
            "opt_state": to_numpy_tree(self._opt_state),
            "applied_step": self._applied_step,
            "last_metrics": dict(self._last_metrics),
            "links": (self._next_store, self._prev_store),
            "stash": {mb: to_numpy_tree(v) for mb, v in self._stash.items()},
            "accum": None if self._accum is None else to_numpy_tree(self._accum),
            "loss_sum": self._loss_sum,
            "busy_s": self._busy_s,
        }

    def __ray_restore__(self, state):
        dev = self._dev
        self._params = to_device_tree(state["params"], dev)
        self._opt_state = to_device_tree(state["opt_state"], dev)
        self._applied_step = state["applied_step"]
        self._last_metrics = state["last_metrics"]
        self._next_store, self._prev_store = state["links"]
        self._stash = {mb: to_device_tree(v, dev)
                       for mb, v in state["stash"].items()}
        self._accum = (None if state["accum"] is None
                       else to_device_tree(state["accum"], dev))
        self._loss_sum = state["loss_sum"]
        self._busy_s = state["busy_s"]
        note("stage_restarts")


# ------------------------------------------------------------ the driver --
class PipelineTrainer:
    """Drive ``num_stages`` PipelineStage actors through the 1F1B
    schedule, one ``step(x, target)`` per optimizer step.

    The driver never blocks inside a step's schedule: it submits every
    stage's call sequence in dependency order, passing descriptor refs as
    args — per-actor FIFO then realizes 1F1B, and the only waits are on
    the per-stage ``apply_grads`` barriers at the end.

    ``schedule="fill_drain"`` instead drives synchronous wave barriers
    (all M forwards of stage s complete before stage s+1 starts — the
    GPipe fill/drain shape with transfers ON the critical path).

    ``optimizer`` follows ``train.core``'s ``init``/``update_`` contract
    (default ``sgd(1e-2)``, the reference's).  ``device``: None is the
    card; ``"cpu"`` is named by callers that want the CPU (see the module
    docstring).  ``stage_params`` are tensors or numpy arrays.

    Runs the single-host path (same micro-batch loss/grad accumulation,
    in this process on ``device``) when ``config.distributed_training``
    is off, a single stage is given, or no runtime is initialized.
    """

    def __init__(self, stage_fn: Callable, loss_fn: Callable,
                 stage_params: Sequence[Any], *, optimizer=None,
                 num_microbatches: int = 0, distributed: Optional[bool]
                 = None, max_restarts: int = 2, max_task_retries: int = -1,
                 max_redrives: int = 2, num_cpus_per_stage: int = 1,
                 device=None):
        self._stage_fn = stage_fn
        self._loss_fn = loss_fn
        self._pp = len(stage_params)
        if self._pp < 1:
            raise ValueError("need at least one stage")
        cfg = active_config()
        self._M = (num_microbatches or cfg.pipeline_microbatches
                   or 2 * self._pp)
        if optimizer is None:
            from ray_tpu_torch.train.core import sgd

            optimizer = sgd(1e-2)
        self._optimizer = optimizer
        self._step_num = 0
        self._max_redrives = max_redrives
        if distributed is None:
            distributed = cfg.distributed_training
        self._distributed = bool(
            distributed and self._pp > 1 and self._runtime_up())
        on_cpu = device is not None and str(device) == "cpu"
        if self._distributed:
            opts = dict(num_cpus=num_cpus_per_stage,
                        max_restarts=max_restarts,
                        max_task_retries=max_task_retries)
            if not on_cpu:
                if device is not None and str(device) not in ("cuda",
                                                              "cuda:0"):
                    raise ValueError(
                        f"stage actors take device None, 'cuda' or 'cpu', "
                        f"not {device!r}: each holds one granted card")
                cards = int(ray.cluster_resources().get("TPU", 0))
                if cards < self._pp:
                    raise RuntimeError(
                        f"{self._pp} card-bound pipeline stages need "
                        f"{self._pp} cards and the runtime has {cards}; "
                        "pass device='cpu' for CPU stage actors")
                opts["num_tpus"] = 1
            self._stages = [
                PipelineStage.options(**opts).remote(
                    stage_fn, loss_fn if s == self._pp - 1 else None,
                    to_numpy_tree(stage_params[s]), self._optimizer, s, self._pp,
                    self._M, "cpu" if on_cpu else "cuda")
                for s in range(self._pp)]
            self._wire_links()
        else:
            from ray_tpu_torch._private.device import resolve_device

            self._dev = resolve_device(device)
            self._local_params = [to_device_tree(to_numpy_tree(p), self._dev)
                                  for p in stage_params]
            self._local_opt_state = self._optimizer.init(
                self._local_params)

    @staticmethod
    def _runtime_up() -> bool:
        from ray_tpu_torch._private import api_internal

        try:
            api_internal.require_runtime()
            return True
        except Exception:
            return False

    # -- wiring -----------------------------------------------------------
    def _wire_links(self):
        stores = ray.get(_bulk_submit(
            [(s.get_store, (), None) for s in self._stages]), timeout=300)
        calls = []
        for i, s in enumerate(self._stages):
            nxt = stores[i + 1] if i + 1 < self._pp else ""
            prv = stores[i - 1] if i > 0 else ""
            calls.append((s.set_links, (nxt, prv), None))
        ray.get(_bulk_submit(calls), timeout=60)

    # -- the 1F1B schedule -------------------------------------------------
    def _stage_sched(self, s: int):
        """Per-stage 1F1B call order: warmup ``min(pp-1-s, M)``
        forwards, steady-state F/B pairs, cooldown backwards — at most
        ``pp`` live stashes per stage."""
        w = min(self._pp - 1 - s, self._M)
        seq = [("F", i) for i in range(w)]
        for i in range(self._M - w):
            seq.append(("F", w + i))
            seq.append(("B", i))
        seq.extend(("B", i) for i in range(self._M - w, self._M))
        return seq

    def _submit_1f1b(self, x_mbs, t_mbs):
        pp, M = self._pp, self._M
        fwd = [[None] * M for _ in range(pp)]
        bwd = [[None] * M for _ in range(pp)]
        scheds = [self._stage_sched(s) for s in range(pp)]
        pos = [0] * pp
        while any(pos[s] < len(scheds[s]) for s in range(pp)):
            progressed = False
            for s in range(pp):
                while pos[s] < len(scheds[s]):
                    kind, i = scheds[s][pos[s]]
                    if kind == "F":
                        if s > 0 and fwd[s - 1][i] is None:
                            break
                        arg = x_mbs[i] if s == 0 else fwd[s - 1][i]
                        tgt = t_mbs[i] if s == pp - 1 else None
                        fwd[s][i] = self._stages[s].forward.remote(
                            i, arg, tgt)
                    else:
                        if s < pp - 1 and bwd[s + 1][i] is None:
                            break
                        arg = bwd[s + 1][i] if s < pp - 1 else None
                        bwd[s][i] = self._stages[s].backward.remote(i, arg)
                    pos[s] += 1
                    progressed = True
            assert progressed, "1F1B schedule deadlocked"
        return bwd

    def _submit_fill_drain(self, x_mbs, t_mbs):
        """Synchronous GPipe fill/drain: per-stage wave barriers, so
        every activation transfer sits on the critical path."""
        pp, M = self._pp, self._M
        prev = None
        for s in range(pp):
            refs = []
            for i in range(M):
                arg = x_mbs[i] if s == 0 else prev[i]
                tgt = t_mbs[i] if s == pp - 1 else None
                refs.append(self._stages[s].forward.remote(i, arg, tgt))
            ray.get(list(refs), timeout=300)  # wave barrier
            prev = refs
        bwd = [[None] * M for _ in range(pp)]
        prev = [None] * M
        for s in range(pp - 1, -1, -1):
            refs = [self._stages[s].backward.remote(i, prev[i])
                    for i in range(M)]
            ray.get(list(refs), timeout=300)  # wave barrier
            bwd[s] = refs
            prev = refs
        return bwd

    # -- stepping ----------------------------------------------------------
    def step(self, x, target, schedule: str = "1f1b") -> Dict[str, float]:
        """One optimizer step over batch ``(x, target)`` (tensors or
        numpy) split into M micro-batches.  On any stage failure the
        whole step re-drives (bounded by ``max_redrives``);
        ``apply_grads`` idempotency keeps params exactly once-advanced."""
        if not self._distributed:
            return self._step_local(x, target)
        # Split before the wire form: a bf16 leaf crosses as tagged bits.
        x_mbs = [to_numpy_tree(v) for v in _split_microbatches(x, self._M)]
        t_mbs = [to_numpy_tree(v)
                 for v in _split_microbatches(target, self._M)]
        step = self._step_num
        last_err = None
        for _attempt in range(self._max_redrives + 1):
            try:
                if schedule == "fill_drain":
                    self._submit_fill_drain(x_mbs, t_mbs)
                else:
                    self._submit_1f1b(x_mbs, t_mbs)
                applies = _bulk_submit(
                    [(s.apply_grads, (step,), None) for s in self._stages])
                metrics = ray.get(list(applies), timeout=300)
                self._step_num += 1
                return metrics[-1]
            except Exception as e:  # noqa: BLE001 — any stage fault
                last_err = e
                self._recover(step)
        raise last_err

    def _recover(self, step: int):
        """Post-fault settle: wait out restarts (ping), refresh the store
        wiring (a restarted stage may live on a new node), and clear
        partial step state on stages that have not applied."""
        for s in self._stages:
            try:
                ray.get(s.ping.remote(), timeout=120)
            except Exception:
                pass
        try:
            self._wire_links()
            ray.get(_bulk_submit(
                [(s.reset_step, (step,), None) for s in self._stages]),
                timeout=60)
        except Exception:
            pass

    # -- single-host path ---------------------------------------------------
    def _step_local(self, x, target) -> Dict[str, float]:
        """Every stage in this process on ``device``: per micro-batch,
        the loss through all stages and its gradients in one graph (each
        stage's layers under remat recompute once, as the reference's
        single program), accumulated ``accum + g`` in microbatch order,
        then divided by M and applied to every stage with one global
        grad norm — the actor path's sums, term for term."""
        import torch

        from ray_tpu_torch.train.core import global_norm

        stage_fn, loss_fn, M = self._stage_fn, self._loss_fn, self._M
        params = self._local_params
        x_mbs = _split_microbatches(to_device_tree(x, self._dev), M)
        t_mbs = _split_microbatches(to_device_tree(target, self._dev), M)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        accum = None
        loss_sum = 0.0
        for x_mb, t_mb in zip(x_mbs, t_mbs):
            with torch.enable_grad():
                y = x_mb
                for p in live:
                    y = stage_fn(p, y)
                loss = loss_fn(y, t_mb)
                g = torch.autograd.grad(loss, leaves)
            loss_sum += float(loss.detach())
            accum = list(g) if accum is None else [
                a + b for a, b in zip(accum, g)]
        grads = tree_unflatten(params, [a / M for a in accum])
        norm = global_norm(tree_leaves(grads))
        self._optimizer.update_(grads, self._local_opt_state, params, norm)
        metrics = {"step": float(self._step_num), "loss": loss_sum / M,
                   "grad_norm": float(norm)}
        self._step_num += 1
        return metrics

    # -- introspection / lifecycle ----------------------------------------
    @property
    def distributed(self) -> bool:
        return self._distributed

    @property
    def num_microbatches(self) -> int:
        return self._M

    def get_stage_params(self) -> List[Any]:
        """Each stage's params as numpy (bf16 as its tagged bits)."""
        if not self._distributed:
            return [to_numpy_tree(p) for p in self._local_params]
        return ray.get(_bulk_submit(
            [(s.get_params, (), None) for s in self._stages]), timeout=120)

    def stage_stats(self) -> List[Dict[str, float]]:
        if not self._distributed:
            return []
        return ray.get(_bulk_submit(
            [(s.stage_stats, (), None) for s in self._stages]), timeout=60)

    def stage_pids(self) -> List[int]:
        if not self._distributed:
            return []
        return ray.get(_bulk_submit(
            [(s.pid, (), None) for s in self._stages]), timeout=60)

    def shutdown(self):
        if not self._distributed:
            return
        for s in self._stages:
            try:
                ray.kill(s)
            except Exception:
                pass
