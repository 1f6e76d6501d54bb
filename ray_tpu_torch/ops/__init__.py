"""ray_tpu_torch.ops — hand-written Hopper kernels and their plain
PyTorch versions (counterpart: ``ray_tpu.ops``), and the MoE layer and
ring and Ulysses sequence-parallel attention, which the reference
computes in XLA with no kernel of its own (Ulysses' attention is K1).

Each kernel wrapper launches its CUDA kernel for CUDA tensors (or raises
on what the kernel does not take) and runs the plain version for CPU
tensors; there is no fallback from one to the other.  Kernels are built
from ``ops/csrc`` at first use (``ops._build``).
"""

from ray_tpu_torch.ops.attention import (
    flash_attention, flash_attention_fwd, mha_reference)
from ray_tpu_torch.ops.layers import (
    apply_rope, repeat_kv_heads, rms_norm, rope, swiglu)
from ray_tpu_torch.ops.moe import MoEOutput, moe_ffn, route_topk
from ray_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.ops.ulysses import ulysses_attention

__all__ = [
    "flash_attention", "flash_attention_fwd", "mha_reference",
    "paged_attention", "paged_attention_reference", "ring_attention",
    "ulysses_attention", "rms_norm", "rope",
    "apply_rope", "swiglu", "repeat_kv_heads", "MoEOutput", "moe_ffn",
    "route_topk",
]
