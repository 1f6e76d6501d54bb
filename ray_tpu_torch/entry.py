"""Entry point of the port, mirroring ``__graft_entry__.entry()``: the
flagship Llama decoder (vocab 32000, embed 768, 12 layers, 6 heads x 128,
mlp 3072, bf16, flash attention) and a batch of 4 x 512 tokens.

    fn, (params, tokens) = entry()      # on cuda:0; device="cpu" to ask
    logits = fn(params, tokens)
"""

from __future__ import annotations

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import LlamaConfig, forward, init_params


def _flagship_cfg() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=32000, embed_dim=768, num_layers=12, num_heads=6,
        num_kv_heads=6, head_dim=128, mlp_dim=3072, max_seq_len=1024,
        dtype=torch.bfloat16, attn_impl="flash", remat=True)


def entry(device=None):
    """(fn, example_args) — the flagship forward on ``device`` (default
    ``cuda:0``; raises without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    cfg = _flagship_cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    tokens = torch.randint(
        0, cfg.vocab_size, (4, 512), dtype=torch.int64, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))

    def fn(params, tokens):
        logits, _ = forward(params, tokens, cfg)
        return logits

    return fn, (params, tokens)
