"""Serving knobs of the PyTorch port.

A small copy of the four serving fields of ``ray_tpu/_private/config.py``
with the same defaults and the same ``RAY_TPU_<FIELD_NAME>`` environment
override (the port imports nothing of ``ray_tpu``).  The rest of the
reference's flag namespace belongs to runtime modules not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get("RAY_TPU_" + name.upper())
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclasses.dataclass
class Config:
    # Continuous batching behind @serve.batch(mode="continuous"): queued
    # requests join the RUNNING batch at step boundaries.  Off = the same
    # step function driven one-shot.
    continuous_batching: bool = True
    # Paged KV cache: a deployment that attaches a kv_cache.PagedKVEngine
    # gets block-granular admission and the paged decode mode
    # (serve/gpu_replica.py).  Off = the dense engine.
    paged_kv: bool = False
    # Shared-prefix reuse on the paged cache (only with paged_kv on).
    prefix_caching: bool = True
    # Speculative decoding draft length; 0 disables (only with paged_kv on).
    speculative_k: int = 0

    @classmethod
    def from_env(cls) -> "Config":
        return cls(**{f.name: _env_override(f.name, f.default)
                      for f in dataclasses.fields(cls)})


GLOBAL_CONFIG = Config.from_env()
