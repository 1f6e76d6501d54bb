"""ray_tpu_torch.serve — the serving decode replica on a CUDA card and the
host-side batching it runs under (counterpart: ``ray_tpu.serve``).

``batching``, ``continuous`` and ``kv_cache`` are the port's own copies of
the reference's modules (they import no JAX, but the port imports nothing
of ``ray_tpu``); ``gpu_replica`` ports ``tpu_replica``.  The serve control
plane (deployments, controller, proxies) belongs to the runtime, which is
not ported yet.
"""

from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

__all__ = ["batch", "MeshShardedDecoder"]
