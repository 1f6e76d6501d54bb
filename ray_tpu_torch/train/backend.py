"""Collective backends: how a worker gang becomes one data-parallel
program (counterpart: ``ray_tpu/train/backend.py``).

Reference seam: ``python/ray/train/torch/config.py:148`` — ``_TorchBackend
.on_start`` runs ``dist.init_process_group`` on every worker over a TCP
rendezvous on rank 0.  The JAX package puts ``jax.distributed`` there;
the port puts ``torch.distributed`` back: rank 0 probes its address and
a free port, then every rank joins one default process group, NCCL when
the worker was granted a card and gloo otherwise.  A granted worker
whose NCCL init fails raises: it never drops to gloo.

``torch.distributed`` is imported inside the functions that run in the
workers, never here: a CPU worker unpickling these functions imports no
torch until one runs.
"""

from __future__ import annotations

from typing import Optional

# Seconds every rank may take to join the group (the rendezvous and the
# first collective).
_JOIN_TIMEOUT_S = 120.0


class Backend:
    """Plugin interface (reference: train/backend.py BackendConfig/Backend)."""

    def on_start(self, worker_group, backend_config) -> None:
        pass

    def on_shutdown(self, worker_group, backend_config) -> None:
        pass


class TorchConfig:
    """Backend config for data-parallel training over torch.distributed.

    ``distributed=None`` joins a process group when the gang has more
    than one worker or its workers are granted cards (so NCCL runs even
    on one card); ``False`` runs each worker as an independent process;
    ``True`` always joins one.  ``coordinator_port`` fixes rank 0's
    rendezvous port (0: probe a free one)."""

    def __init__(self, distributed: Optional[bool] = None,
                 coordinator_port: int = 0):
        self.distributed = distributed
        self.coordinator_port = coordinator_port

    @property
    def backend_cls(self):
        return _TorchBackend


def _rendezvous_addr(fixed_port: int) -> str:
    """Runs on rank 0, whose host runs the TCP store:
    ``tcp://<host>:<port>``.  The host is the address rank 0's node
    advertises, by the runtime's own rule (``RAY_TPU_AGENT_ADVERTISE_HOST``,
    else the listen host: loopback by default, the host's own name on
    ``0.0.0.0``); the port is probed free there unless fixed."""
    import os
    import socket

    host = os.environ.get("RAY_TPU_AGENT_ADVERTISE_HOST")
    if host is None:
        host = os.environ.get("RAY_TPU_AGENT_LISTEN_HOST", "127.0.0.1")
        if host == "0.0.0.0":
            host = socket.gethostbyname(socket.gethostname())
    port = fixed_port
    if not port:
        with socket.socket() as sock:
            sock.bind((host, 0))
            port = sock.getsockname()[1]
    return f"tcp://{host}:{port}"


def _init_process_group(init_method: str, world_size: int, rank: int,
                        backend: str):
    """Runs on every rank: join the default process group, then one
    all-reduce (NCCL makes its communicator at the first collective, so
    a card that cannot join fails here)."""
    import datetime

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.util import tracing

    with tracing.phase("train.process_group"):
        dev = torch.device("cpu")
        if backend == "nccl":
            # The grant narrows this worker to its cards: the first is
            # cuda:0.
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=_JOIN_TIMEOUT_S))
        ones = torch.ones(1, device=dev)
        dist.all_reduce(ones)
        seen = int(ones.item())
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "backend": dist.get_backend(), "ranks_seen": seen}


def _destroy_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class _TorchBackend(Backend):
    """Reference analog: _TorchBackend (train/torch/config.py:103)."""

    def on_start(self, worker_group, backend_config: TorchConfig):
        n = worker_group.num_workers
        granted = worker_group.cards_per_worker > 0
        distributed = backend_config.distributed
        if distributed is None:
            distributed = n > 1 or granted
        if not distributed:
            return
        backend = "nccl" if granted else "gloo"
        addr = worker_group.execute_single(
            0, _rendezvous_addr, backend_config.coordinator_port)
        import ray_tpu_torch as ray
        futs = [w.execute.remote(_init_process_group, addr, n, rank, backend)
                for rank, w in enumerate(worker_group.workers)]
        infos = ray.get(futs, timeout=_JOIN_TIMEOUT_S)
        if any(i["world_size"] != n or i["ranks_seen"] != n
               or i["backend"] != backend for i in infos):
            raise RuntimeError(
                f"inconsistent process group over {n} workers: {infos}")

    def on_shutdown(self, worker_group, backend_config):
        try:
            worker_group.execute(_destroy_process_group)
        except Exception:
            pass  # a dead worker's group went with its process
