"""ray_tpu_torch.serve — model serving (counterpart: ``ray_tpu.serve``).

The control plane (``api``: deployments, the controller actor, handles,
routing, autoscaling, proxies) and the host-side batching it runs
(``batching``, ``continuous``, ``kv_cache``) are the port's own copies of
the reference's modules and import no torch.  ``gpu_replica`` ports
``tpu_replica``: the decode replica on a CUDA card, loaded on first use
so that importing the control plane never imports torch.  A deployment
made with ``num_tpus=k`` (or ``num_gpus=k``) gets replicas in workers
granted k cards.
"""

import importlib as _importlib

from ray_tpu_torch.serve.api import (
    Deployment,
    DeploymentHandle,
    HTTPProxyActor,
    ProxiedDeploymentHandle,
    RequestProxy,
    deployment,
    get_deployment_handle,
    run,
    serving_stats,
    shutdown,
    start,
    start_http_proxy,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.continuous import Slot


def __getattr__(name):
    if name == "MeshShardedDecoder":
        mod = _importlib.import_module("ray_tpu_torch.serve.gpu_replica")
        return mod.MeshShardedDecoder
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["deployment", "Deployment", "DeploymentHandle", "run",
           "get_deployment_handle", "shutdown", "start",
           "start_http_proxy", "HTTPProxyActor", "RequestProxy",
           "ProxiedDeploymentHandle", "serving_stats", "batch", "Slot",
           "MeshShardedDecoder"]
