"""Elementwise/normalization layer primitives (counterpart:
``ray_tpu/ops/layers.py``).  Plain PyTorch on tensors: they sit between
large matmuls and carry no kernel of their own in this slice."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (Llama-style, no mean subtraction).  Stats in f32."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope(seq_len: int, head_dim: int, theta: float = 10000.0,
         offset: int = 0, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary position embedding tables (cos, sin): (seq_len, head_dim/2)."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, d); cos/sin: (s, d/2).  Rotate-half formulation."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU activation: silu(gate) * up."""
    return F.silu(gate) * up


def repeat_kv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Broadcast GQA kv heads up to q's head count (validated)."""
    h, h_kv = q.shape[2], k.shape[2]
    if h == h_kv:
        return k, v
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    rep = h // h_kv
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))
