"""Parameters for the port's Llama: conversion from the reference's param
pytree and train state, and a seeded initializer.

The reference draws its weights with ``jax.random``, whose numbers no
torch generator reproduces, so parity tests convert the reference's own
params (``ray_tpu.models.init_params``, handed over as numpy arrays) with
``params_from_jax``.  ``init_params`` keeps the reference's scheme
(scaled normal with fan-in, norms at one) from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, _dense_layer_shapes


def params_from_jax(np_params: Mapping[str, Any], cfg: LlamaConfig,
                    device=None) -> Dict[str, Any]:
    """The reference's ``{"embed", "layers": {...}, "final_norm",
    "lm_head"}`` pytree of numpy arrays -> the same dict of tensors in
    ``cfg.param_dtype`` on ``device``.  The layout is shared (stacked
    layers, ``x @ W``), so this is a copy."""
    dev = resolve_device(device)

    def conv(x):
        # Through a float32 copy: numpy has no bfloat16 of its own, and
        # jax hands out read-only views.
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=dev, dtype=cfg.param_dtype)

    layers = np_params["layers"]
    expected = _dense_layer_shapes(cfg)
    if set(layers) != set(expected):
        raise ValueError(f"layer params {sorted(layers)} are not the "
                         f"layout of this config {sorted(expected)}")
    return {
        "embed": conv(np_params["embed"]),
        "layers": {k: conv(v) for k, v in layers.items()},
        "final_norm": conv(np_params["final_norm"]),
        "lm_head": conv(np_params["lm_head"]),
    }


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Scaled-normal init (fan-in), norms at one, params in
    ``cfg.param_dtype`` on ``device``; draws come from ``generator`` (on
    its own device) in the reference's order of the layer params (the MoE
    router and experts after the attention), fan-in ``shape[-2]``."""
    dev = resolve_device(device)

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * (fan_in ** -0.5)
        return x.to(device=dev, dtype=cfg.param_dtype)

    layers = {}
    for name, (shape, _) in _dense_layer_shapes(cfg).items():
        full = (cfg.num_layers,) + shape
        if name.endswith("norm"):
            layers[name] = torch.ones(full, dtype=cfg.param_dtype, device=dev)
        else:
            layers[name] = normal(full, shape[-2])
    return {
        "embed": normal((cfg.vocab_size, cfg.embed_dim), 1.0),
        "layers": layers,
        "final_norm": torch.ones((cfg.embed_dim,), dtype=cfg.param_dtype,
                                 device=dev),
        "lm_head": normal((cfg.embed_dim, cfg.vocab_size), cfg.embed_dim),
    }


def _adam_state(opt_state: Any) -> Any:
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax chain
    state of nested tuples, found by its fields (optax is not imported)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_jax(np_state: Any, cfg: LlamaConfig, device=None):
    """The reference's ``TrainState`` (step, params, optax opt_state of
    ``default_optimizer``; leaves handed over as numpy arrays) -> the
    port's ``train.TrainState`` on ``device``: the step, the params, and
    AdamW's count and moments ``mu``/``nu``."""
    from ray_tpu_torch.train.core import TrainState  # train imports models

    adam = _adam_state(np_state.opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam state "
                         "(count, mu, nu)")
    return TrainState(
        step=int(np_state.step),
        params=params_from_jax(np_state.params, cfg, device),
        opt_state={"count": int(adam.count),
                   "mu": params_from_jax(adam.mu, cfg, device),
                   "nu": params_from_jax(adam.nu, cfg, device)})
