"""Flagship model family: Llama-style decoder LM, single device
(counterpart: ``ray_tpu/models/llama.py``, the no-mesh branch).

Params are a plain dict of tensors with the reference's layout: layers are
STACKED on a leading ``(L, ...)`` dim and every projection is ``x @ W``,
so converting the reference's param pytree is a plain copy
(``models.convert``).  Params live in ``cfg.param_dtype`` and are cast to
``cfg.dtype`` (bf16 on the flagship) at use; RMSNorm statistics, logits
and the loss are f32.  Attention goes to the flash kernels K1-K3
(``attn_impl="flash"``) or the plain ``mha_reference``; the large matmuls
stay ``torch.matmul``, as the reference leaves them to XLA.  With
``cfg.remat`` and grad enabled, each layer runs under activation
checkpointing, as the reference wraps its layer in ``jax.checkpoint``: the
backward recomputes the layer's forward (K1 included) instead of keeping
its activations.

Not ported yet (each raises ``NotImplementedError``): ring and Ulysses
sequence-parallel attention, MoE layers, mesh sharding and the pipelined
forward — see ROADMAP.md Queue 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.layers import (
    apply_rope, repeat_kv_heads, rms_norm, rope, swiglu)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    embed_dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    mlp_dim: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attn_impl: str = "flash"          # flash | reference (ring/ulysses later)
    num_experts: int = 0              # 0 = dense FFN (MoE: later)
    num_selected: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    remat: bool = True

    @property
    def qkv_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(embed_dim=5120, num_layers=40, num_heads=40,
                           num_kv_heads=40, mlp_dim=13824, **kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """CI-sized config: runs on one CPU in well under a second."""
        defaults = dict(vocab_size=256, embed_dim=64, num_layers=2,
                        num_heads=4, num_kv_heads=4, head_dim=16, mlp_dim=128,
                        max_seq_len=64, dtype=torch.float32, remat=False,
                        attn_impl="reference")
        defaults.update(kw)
        return LlamaConfig(**defaults)


def dense_layer_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """name -> per-layer shape of the stacked dense layer params."""
    d, h, kvd, m = cfg.embed_dim, cfg.qkv_dim, cfg.kv_dim, cfg.mlp_dim
    return {
        "attn_norm": (d,),
        "wq": (d, h),
        "wk": (d, kvd),
        "wv": (d, kvd),
        "wo": (h, d),
        "mlp_norm": (d,),
        "w_gate": (d, m),
        "w_up": (d, m),
        "w_down": (m, d),
    }


def check_supported(cfg: LlamaConfig) -> None:
    """Raise for the parts of the reference model not ported yet."""
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} needs sequence-parallel attention "
            "(ops/ring_attention.py, ops/ulysses.py), not ported yet: "
            "ROADMAP.md Queue 1, sequence parallelism")
    if cfg.attn_impl not in ("flash", "reference"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.num_experts:
        raise NotImplementedError(
            "num_experts > 0 needs MoE layers (ops/moe.py), not ported yet: "
            "ROADMAP.md Queue 1, MoE")


def _attention(q, k, v, cfg: LlamaConfig):
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=True)
    k, v = repeat_kv_heads(q, k, v)
    return mha_reference(q, k, v, causal=True)


def _layer(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: LlamaConfig,
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One dense transformer layer (the reference's ``_make_layer_fn``
    body without a mesh)."""
    b, s = x.shape[0], x.shape[1]
    h = rms_norm(x, lp["attn_norm"])
    q = (h @ lp["wq"].to(cfg.dtype)).reshape(b, s, cfg.num_heads,
                                             cfg.head_dim)
    k = (h @ lp["wk"].to(cfg.dtype)).reshape(b, s, cfg.num_kv_heads,
                                             cfg.head_dim)
    v = (h @ lp["wv"].to(cfg.dtype)).reshape(b, s, cfg.num_kv_heads,
                                             cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = _attention(q, k, v, cfg).reshape(b, s, cfg.qkv_dim)
    x = x + o @ lp["wo"].to(cfg.dtype)
    h = rms_norm(x, lp["mlp_norm"])
    gate = h @ lp["w_gate"].to(cfg.dtype)
    up = h @ lp["w_up"].to(cfg.dtype)
    return x + swiglu(gate, up) @ lp["w_down"].to(cfg.dtype)


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: LlamaConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (batch, seq) int -> (logits f32 (b, s, vocab), aux_loss)."""
    check_supported(cfg)
    s = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    cos, sin = rope(s, cfg.head_dim, cfg.rope_theta, device=x.device)
    # One unbind per stacked param: its backward stacks the layers' grads
    # in one pass, where indexing w[i] per layer would add L zero-padded
    # (L, ...) grads together.
    layers = {n: w.unbind(0) for n, w in params["layers"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        lp = {n: w[i] for n, w in layers.items()}
        if remat:
            x = checkpoint(_layer, x, lp, cfg, cos, sin, use_reentrant=False)
        else:
            x = _layer(x, lp, cfg, cos, sin)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
    # Dense layers carry no router loss (the reference's aux / num_layers).
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: LlamaConfig, *,
            forward_fn: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy.  batch: {"tokens": (b, s+1)} or
    {"inputs": (b, s), "targets": (b, s)}; returns (loss, metrics).
    ``forward_fn(params, inputs) -> (logits, aux)`` overrides the forward
    pass so there is one loss definition."""
    if "tokens" in batch:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    if forward_fn is None:
        logits, aux = forward(params, inputs, cfg)
    else:
        logits, aux = forward_fn(params, inputs)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    loss = nll.mean()
    total = loss + cfg.aux_loss_coef * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "perplexity": torch.exp(loss)}
