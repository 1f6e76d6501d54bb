"""ray_tpu_torch.models — the flagship Llama family on PyTorch
(counterpart: ``ray_tpu.models``)."""

from ray_tpu_torch.models.convert import (
    init_params, params_from_jax, train_state_from_jax)
from ray_tpu_torch.models.llama import LlamaConfig, forward, loss_fn

__all__ = ["LlamaConfig", "init_params", "params_from_jax",
           "train_state_from_jax", "forward", "loss_fn"]
