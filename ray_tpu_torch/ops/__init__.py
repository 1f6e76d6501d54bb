"""ray_tpu_torch.ops — hand-written Hopper kernels and their plain
PyTorch versions (counterpart: ``ray_tpu.ops``).

Each kernel wrapper launches its CUDA kernel for CUDA tensors (or raises
on what the kernel does not take) and runs the plain version for CPU
tensors; there is no fallback from one to the other.  Kernels are built
from ``ops/csrc`` at first use (``ops._build``).
"""

from ray_tpu_torch.ops.attention import (
    flash_attention, flash_attention_fwd, mha_reference)
from ray_tpu_torch.ops.layers import (
    apply_rope, repeat_kv_heads, rms_norm, rope, swiglu)
from ray_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)

__all__ = [
    "flash_attention", "flash_attention_fwd", "mha_reference",
    "paged_attention", "paged_attention_reference", "rms_norm", "rope",
    "apply_rope", "swiglu", "repeat_kv_heads",
]
