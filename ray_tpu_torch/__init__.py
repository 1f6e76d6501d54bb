"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

The JAX package ``ray_tpu`` stays the reference; this package sits beside
it, imports ``torch`` and never ``jax``, and nothing of ``ray_tpu``.

Two planes, as in the reference:

- The Ray-style runtime (head, workers, shm object store, actors, the
  serve control plane) is a copy of the reference's, re-pointed at this
  package, with the host's NVIDIA cards as its accelerator pool:
  ``num_tpus`` and ``num_gpus`` both draw from it, and a granted worker
  sees its cards through ``CUDA_VISIBLE_DEVICES``.  It imports no torch.

      import ray_tpu_torch as ray
      ray.init()
      @ray.remote(num_gpus=1)
      def f(x): ...

- The compute layer (``entry``, ``models``, ``ops``, ``train``,
  ``rllib`` and ``serve.gpu_replica``): the flagship Llama forward, train
  step and pipeline trainer, the RL learners and the paged serving
  decoder, each Pallas kernel of the reference a
  hand-written CUDA kernel for Hopper (``sm_90a``) with a plain PyTorch
  version beside it for CPU tensors.  Entry points default to ``cuda:0``
  and raise without a card unless ``device="cpu"`` is given.  These
  modules load on first attribute access, so a CPU worker never imports
  torch.
"""

import importlib as _importlib
import os as _os

# Opt-in lock-order checker (RAY_TPU_LOCKCHECK=1 logs cycles, =raise
# raises).  Must install BEFORE the runtime modules below are imported so
# their module- and instance-level locks are minted as recording proxies.
if _os.environ.get("RAY_TPU_LOCKCHECK", "0") not in ("", "0"):
    from ray_tpu_torch.devtools import lockcheck as _lockcheck

    _lockcheck.install_from_env()

from ray_tpu_torch._private.api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor, method
from ray_tpu_torch.remote_function import RemoteFunction, remote_decorator
from ray_tpu_torch.runtime_context import get_runtime_context
from ray_tpu_torch.util.tracing import timeline  # noqa: F401 (public API)
from ray_tpu_torch import exceptions

__version__ = "0.1.0"

# The compute layer imports torch: loaded on first use.
_LAZY = ("entry", "models", "ops", "rllib", "serve", "train", "tune")


def __getattr__(name):
    if name in _LAZY:
        return _importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_tpus=...)`` decorator
    (reference: python/ray/_private/worker.py remote)."""
    if len(args) == 1 and not kwargs and callable(args[0]):
        return remote_decorator(None)(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return remote_decorator(kwargs)


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "nodes", "cluster_resources",
    "available_resources", "ObjectRef", "ActorClass", "ActorHandle",
    "RemoteFunction", "get_runtime_context", "timeline", "exceptions",
    "entry", "models", "ops", "serve", "train", "__version__",
]
