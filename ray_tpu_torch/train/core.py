"""The train step of the port on one device (counterpart:
``ray_tpu/train/core.py`` without a mesh).

The reference jits loss -> grad -> optax update over its mesh; here the
step runs eagerly on one device: ``loss_fn`` of the port's Llama, the
gradients by autograd (through the flash kernels K1-K3 on the card, and
the per-layer recompute when ``cfg.remat`` is set), then an AdamW that
repeats optax's ``chain(clip_by_global_norm, adamw(warmup_cosine))``:
on the card the two kernels of ``ops.optim`` (the global norm, then the
clipped update of every leaf in one launch), where the reference leaves
it to XLA; on the CPU their plain versions.

    state = init_train_state(cfg, default_optimizer(), generator)
    step = make_train_step(cfg, default_optimizer())
    state, metrics = step(state, {"tokens": tokens})   # (b, s+1) int

The step updates the state's tensors in place and returns the same state
object: the counterpart of the reference's ``donate_argnums``.

Data parallelism: when a default ``torch.distributed`` process group is
initialised (``train.TorchConfig`` does so in each trainer worker, world
size 1 included), ``loss_and_grads`` averages the gradients over it before
the global norm and the clip, in a few flat f32 buckets as DDP does, and
averages the loss: the counterpart of the reference's gradient of the
global batch over its ``dp`` axis.  Each rank then takes the same update
from its own shard of the batch.  Without a group the step is the
one-device step.  MoE routes over the global batch, which no average of
per-rank steps gives: for ``num_experts > 0`` a group of more than one
rank runs the step as a ``dp`` mesh over its ranks (each rank's batch its
shard of the global one), so the router sees every token.

Sharded (``mesh=``): the params and AdamW's moments are DTensors at the
placements of ``param_logical_axes`` under the rules, the loss is that of
the global batch, and the grads come back from autograd as DTensors,
reduced over the batch axes and redistributed to their params'
placements; the update runs on each rank's local shards.  With
``pipelined=True`` the forward is ``forward_pipelined`` (the GPipe
schedule over 'pp'), as the reference's ``compute_loss`` passes it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.models.convert import init_params
from ray_tpu_torch.models.llama import (
    LlamaConfig, forward_pipelined, loss_fn, param_logical_axes)
from ray_tpu_torch.ops.optim import adamw_, global_norm
from ray_tpu_torch.parallel.mesh import Mesh, make_mesh
from ray_tpu_torch.parallel.sharding import LogicalAxisRules, shard_pytree
from ray_tpu_torch.train.trees import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.util import tracing

# Elements per all-reduce bucket when averaging grads over a process
# group (f32: 128 MB a bucket, a few calls for the flagship's 162M).
_BUCKET_NUMEL = 32 << 20


@dataclasses.dataclass
class TrainState:
    """``step`` counts the updates taken; ``params`` is the model's param
    dict; ``opt_state`` is the optimizer's (``AdamW.init``)."""
    step: int
    params: Dict[str, Any]
    opt_state: Dict[str, Any]


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: in-place updates reach it)."""
    return x.to_local() if isinstance(x, DTensor) else x


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule with its default end value 0:
    linear from ``init_value`` to ``peak_value`` over ``warmup_steps``,
    then cosine down to 0 at ``decay_steps`` (counted from 0, warmup
    included), and 0 after it."""
    if decay_steps <= warmup_steps:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        return peak_value * 0.5 * (1.0 + math.cos(math.pi * c / span))

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(schedule,
    b1, b2, eps, weight_decay))`` on a param tree, updating in place
    (the flagship's: b1=0.9, b2=0.95, eps=1e-8, as the reference's
    ``default_optimizer`` gives them to optax.adamw, core.py:96).

    Clipping scales by ``grad_clip / norm`` only when ``norm >=
    grad_clip``; ``grad_clip=None`` does not clip.  The decay is
    decoupled and applies to every leaf (norms included), and the
    learning rate is ``schedule(count)`` at the count BEFORE the update,
    so a warmup from 0 makes the first step a no-op."""
    schedule: Callable[[int], float]
    weight_decay: float
    grad_clip: Optional[float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    def init(self, params: Any) -> Dict[str, Any]:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, grads: Any, opt_state: Dict[str, Any], params: Any,
                grad_norm: torch.Tensor) -> None:
        """One step on ``params`` and ``opt_state`` in place;
        ``grad_norm`` is ``global_norm`` of ``grads``.  Sharded leaves
        (grads at their params' placements) update their local shards."""
        count = opt_state["count"]
        adamw_(list(map(_local, tree_leaves(params))),
               list(map(_local, tree_leaves(grads))),
               list(map(_local, tree_leaves(opt_state["mu"]))),
               list(map(_local, tree_leaves(opt_state["nu"]))), grad_norm,
               grad_clip=self.grad_clip, b1=self.b1, b2=self.b2,
               eps=self.eps, weight_decay=self.weight_decay,
               lr=self.schedule(count), bc1=1.0 - self.b1 ** (count + 1),
               bc2=1.0 - self.b2 ** (count + 1))
        opt_state["count"] = count + 1


@dataclasses.dataclass(frozen=True)
class SGD:
    """optax.sgd(lr): ``p + (-lr * g)``, in place, with the same
    ``init``/``update_`` contract as ``AdamW`` (no state)."""
    lr: float

    def init(self, params: Any) -> Dict[str, Any]:
        return {}

    @torch.no_grad()
    def update_(self, grads: Any, opt_state: Dict[str, Any], params: Any,
                grad_norm: torch.Tensor) -> None:
        for p, g in zip(map(_local, tree_leaves(params)),
                        map(_local, tree_leaves(grads))):
            p.add_(g * -self.lr)


def _constant(value: float) -> Callable[[int], float]:
    return lambda count: value


def sgd(lr: float) -> SGD:
    """optax.sgd(lr) (the actor pipeline's default, at 1e-2)."""
    return SGD(lr)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         grad_clip: Optional[float] = None) -> AdamW:
    """optax.adam(lr, b1, b2, eps), behind ``clip_by_global_norm(grad_clip)``
    when it is given: optax's ``chain(clip_by_global_norm, adam)``, the
    rllib learners' optimizer."""
    return AdamW(_constant(lr), weight_decay=0.0, grad_clip=grad_clip,
                 b1=b1, b2=b2, eps=eps)


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, decay_steps: int = 10000,
                      grad_clip: float = 1.0) -> AdamW:
    """AdamW + cosine schedule + clipping, the reference's LLM recipe."""
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup,
                                         max(decay_steps, warmup + 1))
    return AdamW(sched, weight_decay=weight_decay, grad_clip=grad_clip)


def train_state_from_params(params: Dict[str, Any],
                            optimizer: AdamW) -> TrainState:
    """A fresh state at step 0 around existing params (for example the
    reference's, converted by ``models.params_from_jax``)."""
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params))


def init_train_state(cfg: LlamaConfig, optimizer: AdamW,
                     generator: torch.Generator, device=None, *,
                     mesh: Optional[Mesh] = None,
                     rules: Optional[LogicalAxisRules] = None
                     ) -> TrainState:
    """Params from ``models.init_params`` (drawn from ``generator``) on
    ``device`` (default ``cuda:0``, or the mesh's device type), and the
    optimizer's fresh state.  With ``mesh`` the params are sharded at
    their logical axes under ``rules``, and AdamW's moments like them."""
    if mesh is not None and device is None:
        device = mesh.device_type
    params = init_params(cfg, generator, device)
    if mesh is not None:
        params = shard_pytree(params, param_logical_axes(cfg), mesh, rules)
    return train_state_from_params(params, optimizer)


def loss_and_grads(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   cfg: LlamaConfig, *, mesh: Optional[Mesh] = None,
                   rules: Optional[LogicalAxisRules] = None,
                   forward_fn: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, Any]]:
    """``(total loss, metrics, grads)`` of ``loss_fn`` at ``params``
    (with ``forward_fn`` in place of the forward, as ``loss_fn`` takes
    it); grads have the params' tree and dtypes.  Under ``mesh`` they are
    DTensors at their params' placements.  Under a default process group
    without a mesh, grads, loss and perplexity are those of the whole
    batch (averaged over the ranks; for MoE, routed over it)."""
    if mesh is None and cfg.num_experts and _group_size() > 1:
        return _moe_over_group(params, batch, cfg)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    with torch.enable_grad():
        with tracing.span("train.forward"):
            total, metrics = loss_fn(live, batch, cfg, mesh=mesh,
                                     rules=rules, forward_fn=forward_fn)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(total, leaves)
    metrics = {k: m.detach() for k, m in metrics.items()}
    total = total.detach()
    with tracing.span("train.grad_sync"):
        if mesh is not None:
            # Sums still pending over the batch axes are reduced here.
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        elif _group_size():
            grads = _average_grads(grads)
            total, metrics = _average_metrics(metrics, cfg)
    return total, metrics, tree_unflatten(params, grads)


def _group_size() -> int:
    """The default process group's world size, 0 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def _moe_over_group(params, batch, cfg: LlamaConfig):
    """``loss_and_grads`` of an MoE model under a process group and no
    mesh: the group as a ``dp`` mesh, each rank's params its replica and
    its batch its shard of the global one (the ranks' batches must have
    one shape), so routing sees the whole batch; the grads come back
    summed over the ranks, as plain tensors."""
    mesh = make_mesh(device_type=tree_leaves(params)[0].device.type)
    dm, rep, shard = mesh.device_mesh, [Replicate()], [Shard(0)]
    total, metrics, grads = loss_and_grads(
        tree_map(lambda p: DTensor.from_local(p, dm, rep, run_check=False),
                 params),
        {k: DTensor.from_local(v, dm, shard, run_check=False)
         for k, v in batch.items()},
        cfg, mesh=mesh)
    return total, metrics, tree_map(lambda g: g.to_local(), grads)


def _average_grads(grads) -> List[torch.Tensor]:
    """The mean of every rank's grads over the default process group: one
    f32 all-reduce per flat bucket of up to ``_BUCKET_NUMEL`` elements
    (not one per leaf); each grad keeps its dtype."""
    import torch.distributed as dist

    buckets, cur, n = [], [], 0
    for g in grads:
        if cur and n + g.numel() > _BUCKET_NUMEL:
            buckets.append(cur)
            cur, n = [], 0
        cur.append(g)
        n += g.numel()
    buckets.append(cur)
    world = dist.get_world_size()
    out: List[torch.Tensor] = []
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        dist.all_reduce(flat)
        flat.div_(world)
        parts = flat.split([g.numel() for g in bucket])
        out += [p.view(g.shape).to(g.dtype) for g, p in zip(bucket, parts)]
    return out


def _average_metrics(metrics, cfg: LlamaConfig):
    """``(total, metrics)`` with the loss terms averaged over the default
    process group (every rank's shard has as many tokens, so this is the
    loss of the whole batch) and the perplexity of that loss, as the
    reference reports for its global batch."""
    import torch.distributed as dist

    vals = torch.stack([metrics["loss"].float(),
                        metrics["aux_loss"].float()])
    dist.all_reduce(vals)
    vals.div_(dist.get_world_size())
    loss, aux = vals[0], vals[1]
    metrics = dict(metrics, loss=loss, aux_loss=aux,
                   perplexity=torch.exp(loss))
    return loss + cfg.aux_loss_coef * aux, metrics


def make_train_step(cfg: LlamaConfig, optimizer: AdamW, *,
                    mesh: Optional[Mesh] = None,
                    rules: Optional[LogicalAxisRules] = None,
                    pipelined: bool = False, num_microbatches: int = 1
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step.  Batch: {"tokens": (b, s+1) int}, the global batch
    under ``mesh`` (with the state from ``init_train_state(mesh=...)``).
    ``pipelined``: the forward is ``forward_pipelined`` over the mesh's
    'pp' axis with ``num_microbatches`` (a mesh is needed).  Metrics:
    ``loss``, ``aux_loss``, ``perplexity`` and ``grad_norm`` (the global
    norm of the raw grads, before clipping), as 0-d f32 tensors."""
    forward_fn = None
    if pipelined:
        if mesh is None:
            raise ValueError("a pipelined train step needs a mesh")
        forward_fn = functools.partial(
            forward_pipelined, cfg=cfg, mesh=mesh,
            num_microbatches=num_microbatches, rules=rules)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        _, metrics, grads = loss_and_grads(state.params, batch, cfg,
                                           mesh=mesh, rules=rules,
                                           forward_fn=forward_fn)
        with tracing.span("train.optimizer"):
            grad_norm = global_norm(tree_leaves(grads))
            optimizer.update_(grads, state.opt_state, state.params,
                              grad_norm)
        state.step += 1
        return state, dict(metrics, grad_norm=grad_norm)

    return step
