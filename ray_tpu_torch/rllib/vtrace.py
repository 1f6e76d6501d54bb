"""V-trace off-policy correction (counterpart: ``ray_tpu/rllib/vtrace.py``).

Reference: ``rllib/algorithms/impala/vtrace_torch.py`` (from the IMPALA
paper, Espeholt et al. 2018).  The recurrence

    vs_t = V(x_t) + delta_t + gamma * c_t * (vs_{t+1} - V(x_{t+1}))
    delta_t = rho_t * (r_t + gamma * V(x_{t+1}) - V(x_t))

runs backward in time over (T, B) tensors: a Python loop over T, batched
over B, where the reference has a reversed ``lax.scan``.  The targets
carry no gradient, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor             # (T, B) value targets
    pg_advantages: torch.Tensor  # (T, B) policy-gradient advantages


@torch.no_grad()
def vtrace(behavior_logp: torch.Tensor, target_logp: torch.Tensor,
           rewards: torch.Tensor, values: torch.Tensor,
           bootstrap_value: torch.Tensor, discounts: torch.Tensor,
           clip_rho_threshold: float = 1.0,
           clip_c_threshold: float = 1.0) -> VTraceReturns:
    """All inputs (T, B) time-major; bootstrap_value (B,);
    discounts = gamma * (1 - done)."""
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=clip_rho_threshold)
    c = torch.clamp(ratio, max=clip_c_threshold)
    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rho * (rewards + discounts * values_tp1 - values)
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = torch.empty_like(values)
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * c[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    vs_tp1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = rho * (rewards + discounts * vs_tp1 - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_adv)
