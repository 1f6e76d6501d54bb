"""The train step of the port on one device (counterpart:
``ray_tpu/train/core.py`` without a mesh).

The reference jits loss -> grad -> optax update over its mesh; here the
step runs eagerly on one device: ``loss_fn`` of the port's Llama, the
gradients by autograd (through the flash kernels K1-K3 on the card, and
the per-layer recompute when ``cfg.remat`` is set), then an AdamW that
repeats optax's ``chain(clip_by_global_norm, adamw(warmup_cosine))``.
The optimizer is plain PyTorch, as the reference leaves it to XLA.

    state = init_train_state(cfg, default_optimizer(), generator)
    step = make_train_step(cfg, default_optimizer())
    state, metrics = step(state, {"tokens": tokens})   # (b, s+1) int

The step updates the state's tensors in place and returns the same state
object: the counterpart of the reference's ``donate_argnums``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from ray_tpu_torch.models.convert import init_params
from ray_tpu_torch.models.llama import LlamaConfig, loss_fn

# AdamW's moment decays and epsilon, as the reference's default_optimizer
# gives them to optax.adamw (core.py:96).
_B1, _B2, _EPS = 0.9, 0.95, 1e-8


@dataclasses.dataclass
class TrainState:
    """``step`` counts the updates taken; ``params`` is the model's param
    dict; ``opt_state`` is the optimizer's (``AdamW.init``)."""
    step: int
    params: Dict[str, Any]
    opt_state: Dict[str, Any]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the tensor leaves of nested dicts, in sorted key order
    (the order of ``tree_leaves``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all leaves together, f32."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


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
    b1=0.9, b2=0.95, eps=1e-8, weight_decay))`` on a param tree, updating
    in place.

    Clipping scales by ``grad_clip / norm`` only when ``norm >=
    grad_clip``.  The decay is decoupled and applies to every leaf (norms
    included), and the learning rate is ``schedule(count)`` at the count
    BEFORE the update, so a warmup from 0 makes the first step a no-op."""
    schedule: Callable[[int], float]
    weight_decay: float
    grad_clip: float

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, grads: Dict[str, Any], opt_state: Dict[str, Any],
                params: Dict[str, Any], grad_norm: torch.Tensor) -> None:
        """One step on ``params`` and ``opt_state`` in place;
        ``grad_norm`` is ``global_norm`` of ``grads``."""
        count = opt_state["count"]
        lr = self.schedule(count)
        bc1 = 1.0 - _B1 ** (count + 1)
        bc2 = 1.0 - _B2 ** (count + 1)
        keep = grad_norm < self.grad_clip
        gs = [torch.where(keep, g, g / grad_norm * self.grad_clip)
              for g in tree_leaves(grads)]
        for p, g, m, v in zip(tree_leaves(params), gs,
                              tree_leaves(opt_state["mu"]),
                              tree_leaves(opt_state["nu"])):
            m.mul_(_B1).add_(g, alpha=1.0 - _B1)
            v.mul_(_B2).addcmul_(g, g, value=1.0 - _B2)
            upd = (m / bc1) / ((v / bc2).sqrt() + _EPS)
            upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)
        opt_state["count"] = count + 1


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
                     generator: torch.Generator, device=None) -> TrainState:
    """Params from ``models.init_params`` (drawn from ``generator``) on
    ``device`` (default ``cuda:0``), and the optimizer's fresh state."""
    return train_state_from_params(init_params(cfg, generator, device),
                                   optimizer)


def loss_and_grads(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   cfg: LlamaConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, Any]]:
    """``(total loss, metrics, grads)`` of ``loss_fn`` at ``params``;
    grads have the params' tree and dtypes."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        total, metrics = loss_fn(live, batch, cfg)
        grads = torch.autograd.grad(total, leaves)
    it = iter(grads)
    return (total.detach(), {k: m.detach() for k, m in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(cfg: LlamaConfig, optimizer: AdamW
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step.  Batch: {"tokens": (b, s+1) int}.  Metrics:
    ``loss``, ``aux_loss``, ``perplexity`` and ``grad_norm`` (the global
    norm of the raw grads, before clipping), as 0-d f32 tensors."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        _, metrics, grads = loss_and_grads(state.params, batch, cfg)
        grad_norm = global_norm(tree_leaves(grads))
        optimizer.update_(grads, state.opt_state, state.params, grad_norm)
        state.step += 1
        return state, dict(metrics, grad_norm=grad_norm)

    return step
