"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute layer.

The JAX package ``ray_tpu`` stays the reference; this package sits beside
it, imports ``torch`` and never ``jax``, and nothing of ``ray_tpu``.  Every
Pallas kernel on a ported path is a hand-written CUDA kernel for Hopper
(``sm_90a``) with a plain PyTorch version beside it, which is what runs on
CPU tensors.  Entry points default to ``cuda:0`` and raise without a card
unless ``device="cpu"`` is given.

Ported so far: the flagship Llama forward (``models``, ``entry``) and its
train step (``train``) with the flash-attention forward and backward
kernels, and the paged serving decoder (``serve.gpu_replica``) with the
paged decode-attention kernel.  There are no runtime re-exports: the
Ray-style runtime is not ported yet.
"""

from ray_tpu_torch import entry, models, ops, serve, train

__version__ = "0.1.0"

__all__ = ["entry", "models", "ops", "serve", "train", "__version__"]
